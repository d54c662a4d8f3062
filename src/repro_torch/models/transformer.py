"""Model assembly: the dense, moe, vlm, ssm (RWKV6), hybrid (Zamba2) and encdec
(SeamlessM4T) families.

One :class:`LM` object per config exposes plain functions over a params dict
(stacked leading "layers" axis, the reference's paths):

  * ``init(generator, device=...) -> params``
  * ``train_loss(params, batch)``     (teacher-forced CE over the padded vocab
                                       + the MoE aux loss)
  * ``prefill_logits(params, batch)`` (last-position logits)
  * ``decode_step(params, batch, cache) -> (logits, cache)``
  * ``init_cache(batch, max_len, enc_len=0, device=...)`` / ``flush_cache(cache)``

The layer stack is a Python loop over the stacked weights.  With
``remat="full"`` each layer of a forward that autograd records is
recomputed in the backward pass (``torch.utils.checkpoint``), the
reference's ``jax.checkpoint`` of the scan body (in the hybrid family, of
the Mamba body only, as there); with ``remat="dots"`` the same layers save
the outputs of their matrix products that have no batch dimension and
recompute the rest (the reference's ``checkpoint_dots_with_no_batch_dims``).
Caches are written in place: K/V rows, and the recurrent states of the ssm
and hybrid families.  The moe family is the dense one with its MLP replaced
by routed experts (``models/moe.py``), whose load-balance loss each layer
returns.  The vlm family (Qwen2-VL) is the dense one with M-RoPE positions
(B, S, 3) and precomputed patch embeddings written over the first positions
of the token stream.  The encdec family (SeamlessM4T) runs a bidirectional
encoder over precomputed frame embeddings (``batch["enc_embeds"]``), then a
causal decoder whose layers add cross-attention to the encoder output; in
decode the encoder's per-layer K/V sit in the cache's ``"cross"`` entry and
only the ``"self"`` split cache grows.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models.attention import apply_attention, attn_defs, project
from repro_torch.models.params import ParamDef, init_params, map_defs


def stack_defs(defs: Any, n: int) -> Any:
    """Add a leading "layers" axis to every ParamDef."""
    return map_defs(
        lambda d: ParamDef((n,) + d.shape, d.init, d.scale, d.f32), defs
    )


def layer_params(stacked: Dict, li: int) -> Dict:
    """Layer ``li`` of a stacked params tree (views, no copies)."""
    if isinstance(stacked, torch.Tensor):
        return stacked[li]
    if isinstance(stacked, tuple):   # a (k, v) pair or a state NamedTuple
        vals = [layer_params(v, li) for v in stacked]
        return type(stacked)(*vals) if hasattr(stacked, "_fields") else tuple(vals)
    return {k: layer_params(v, li) for k, v in stacked.items()}


def cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------

_aten = torch.ops.aten


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the output of a matrix product with no batch dimension (``mm``,
    ``addmm``, or a ``bmm`` one of whose operands is broadcast over its
    batch, which is what ``x @ w`` becomes where ATen does not fold x into
    one ``mm``); recompute everything else, the attention's and the
    experts' batched products included."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and 0 in (args[0].stride(0), args[1].stride(0))):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: Optional[str], *args):
    """``fn(*args)``, under ``policy``'s rematerialization where autograd
    records it."""
    if policy is None or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _dots_policy))


# ---------------------------------------------------------------------------
# per-family layer bodies.  A state or cache given is a view of the layer's
# slice of the stacked cache, and is written in place.
# ---------------------------------------------------------------------------

def _dense_block(lp, cfg, impl, x, pos, cache, cache_len):
    """Returns (x, new_cache, aux): aux is the MoE layer's load-balance loss
    (f32), None without experts."""
    h = L.apply_norm(lp["ln1"], x)
    a, new_cache = apply_attention(
        lp["attn"], cfg, h, pos,
        impl=impl, causal=True, cache=cache, cache_len=cache_len,
    )
    x = x + a
    h = L.apply_norm(lp["ln2"], x)
    if cfg.n_experts:
        m, aux = MOE.apply_moe(lp["moe"], cfg, h)
        return x + m, new_cache, aux
    return x + L.apply_mlp(lp["mlp"], h), new_cache, None


def _rwkv_block(lp, cfg, x, state: Optional[R6.RwkvState]):
    h = L.apply_norm(lp["ln1"], x)
    a, tm_new = R6.apply_time_mix(lp["tm"], cfg, h, state)
    x = x + a
    h = L.apply_norm(lp["ln2"], x)
    m, cm_shift = R6.apply_channel_mix(
        lp["cm"], cfg, h, state.shift_cm if state is not None else None
    )
    if state is not None:
        state.shift_tm.copy_(tm_new[0])
        state.wkv.copy_(tm_new[1])
        state.shift_cm.copy_(cm_shift)
    return x + m


def _mamba_block(lp, cfg, x, state: Optional[M2.MambaState]):
    h = L.apply_norm(lp["ln"], x)
    a, new_state = M2.apply_mamba(lp["mamba"], cfg, h, state)
    if state is not None:
        state.conv.copy_(new_state.conv)
        state.ssd.copy_(new_state.ssd)
    return x + a


class LM:
    def __init__(
        self, cfg: ModelConfig, *, attn_impl: str = "naive", remat: Optional[str] = "full"
    ):
        family = "moe" if cfg.n_experts else cfg.family
        if cfg.is_encdec:
            family = "encdec"
        if remat not in (None, "none", "full", "dots"):
            raise ValueError(remat)
        self.cfg = cfg
        self.family = family
        self.attn_impl = attn_impl
        self.remat = None if remat == "none" else remat
        self.dtype = torch_dtype(cfg.dtype)

    # -- parameter definitions ------------------------------------------------
    def _layer_defs(self) -> Dict:
        cfg = self.cfg
        if self.family == "ssm":
            return {
                "ln1": L.norm_defs(cfg),
                "tm": R6.time_mix_defs(cfg),
                "ln2": L.norm_defs(cfg),
                "cm": R6.channel_mix_defs(cfg),
            }
        if self.family == "hybrid":
            return {"ln": L.norm_defs(cfg), "mamba": M2.mamba_defs(cfg)}
        out = {
            "ln1": L.norm_defs(cfg),
            "attn": attn_defs(cfg),
            "ln2": L.norm_defs(cfg),
        }
        if self.family == "moe":
            out["moe"] = MOE.moe_defs(cfg)
        else:
            out["mlp"] = L.mlp_defs(cfg)
        return out

    def param_defs(self) -> Dict:
        cfg = self.cfg
        defs = {"embed": L.embed_defs(cfg), "final_ln": L.norm_defs(cfg)}
        if self.family == "encdec":
            enc_layer = {
                "ln1": L.norm_defs(cfg),
                "attn": attn_defs(cfg),
                "ln2": L.norm_defs(cfg),
                "mlp": L.mlp_defs(cfg),
            }
            dec_layer = {
                "ln1": L.norm_defs(cfg),
                "attn": attn_defs(cfg),
                "lnx": L.norm_defs(cfg),
                "xattn": attn_defs(cfg),
                "ln2": L.norm_defs(cfg),
                "mlp": L.mlp_defs(cfg),
            }
            defs["encoder"] = stack_defs(enc_layer, cfg.enc_layers)
            defs["enc_ln"] = L.norm_defs(cfg)
            defs["decoder"] = stack_defs(dec_layer, cfg.n_layers)
            return defs
        defs["layers"] = stack_defs(self._layer_defs(), cfg.n_layers)
        if self.family == "hybrid":
            defs["shared_attn"] = {
                "ln": L.norm_defs(cfg),
                "attn": attn_defs(cfg),
                "ln2": L.norm_defs(cfg),
                "mlp": L.mlp_defs(cfg),
            }
        return defs

    def init(self, generator: torch.Generator | int = 0, *, device="cuda") -> Dict:
        """Random weights with the reference's init rule, drawn on ``device``
        from ``generator`` (or a fresh one seeded with the given int)."""
        device = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=device).manual_seed(int(generator))
        return init_params(
            self.param_defs(), dtype=self.dtype, generator=generator, device=device
        )

    # -- forward helpers --------------------------------------------------------
    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token embeddings, with a vision config's ``patch_embeds`` (B, n,
        d) cast to the model dtype and written over the first n positions.
        Patches longer than the token stream raise, as the reference's
        ``dynamic_update_slice`` does."""
        x = L.embed_tokens(params["embed"], batch["tokens"], self.dtype)
        if self.cfg.frontend == "vision" and "patch_embeds" in batch:
            pe = batch["patch_embeds"]
            B, S, d = x.shape
            if pe.dim() != 3 or pe.shape[0] != B or pe.shape[2] != d or pe.shape[1] > S:
                raise ValueError(f"patch_embeds {tuple(pe.shape)} do not fit in the token "
                                 f"embeddings {tuple(x.shape)}")
            x = torch.cat([pe.to(self.dtype), x[:, pe.shape[1]:]], dim=1)
        return x, batch["positions"]

    def _run_decoder_stack(self, params, x, pos, caches, cache_len, enc_out=None,
                           enc_len=None):
        """Layer loop; returns (x, caches, aux) with the caches updated in
        place.  aux is the MoE layers' load-balance loss summed in f32 in
        layer order (None for the other families).  The encdec family's
        decoder attends to ``enc_out`` (no cache) or to the cache's
        ``"cross"`` K/V, of ``enc_len`` tokens."""
        cfg = self.cfg
        remat = self.remat if caches is None else None
        if self.family == "encdec":
            for li in range(cfg.n_layers):
                cache = None if caches is None else layer_params(caches, li)
                x = _remat(self._decoder_layer, remat, layer_params(params["decoder"], li), x,
                           pos, enc_out, enc_len, cache, cache_len)
            return x, caches, None
        aux = None
        for li in range(cfg.n_layers):
            lp = layer_params(params["layers"], li)
            a = None
            if caches is None:
                x, a = _remat(self._layer, remat, lp, x, pos)
            elif self.family == "ssm":
                x = _rwkv_block(lp, cfg, x, layer_params(caches, li))
            elif self.family == "hybrid":
                x = _mamba_block(lp, cfg, x, layer_params(caches["mamba"], li))
            else:
                x, _, a = _dense_block(lp, cfg, self.attn_impl, x, pos,
                                       layer_params(caches, li), cache_len)
            if a is not None:
                aux = a if aux is None else aux + a
            if self.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
                # the shared block after each group of attn_every Mamba layers
                # (zamba2: 13 groups of 6, then 3 remainder layers), each
                # application with its own split cache
                g = (li + 1) // cfg.attn_every - 1
                cache = None if caches is None else layer_params(caches["attn"], g)
                sp = params["shared_attn"]   # a dense block whose first norm is "ln"
                x, _, _ = _dense_block(dict(sp, ln1=sp["ln"]), cfg, self.attn_impl, x, pos,
                                       cache, cache_len)
        return x, caches, aux

    def _layer(self, lp, x, pos):
        """One layer without a cache (the body ``remat`` recomputes):
        (x, aux), aux None but in the moe family."""
        if self.family == "ssm":
            return _rwkv_block(lp, self.cfg, x, None), None
        if self.family == "hybrid":
            return _mamba_block(lp, self.cfg, x, None), None
        x, _, aux = _dense_block(lp, self.cfg, self.attn_impl, x, pos, None, None)
        return x, aux

    def _decoder_layer(self, lp, x, pos, enc_out, enc_len, cache=None, cache_len=None):
        """One encdec decoder layer: causal self-attention (into the
        ``"self"`` split cache where there is one), cross-attention over the
        cache's ``"cross"`` K/V or, without a cache, over ``enc_out``'s, and
        the MLP."""
        cfg, impl = self.cfg, self.attn_impl
        h = L.apply_norm(lp["ln1"], x)
        a, _ = apply_attention(lp["attn"], cfg, h, pos, impl=impl, causal=True,
                               cache=None if cache is None else cache["self"],
                               cache_len=cache_len)
        x = x + a
        h = L.apply_norm(lp["lnx"], x)
        kv = self._encoder_kv(lp["xattn"], enc_out) if cache is None else cache["cross"]
        a, _ = apply_attention(lp["xattn"], cfg, h, pos, impl=impl, kv_override=kv,
                               cache_len=enc_len)
        x = x + a
        h = L.apply_norm(lp["ln2"], x)
        return x + L.apply_mlp(lp["mlp"], h)

    def _encoder_kv(self, attn_params, enc_out):
        """The cross-attention K/V of ``enc_out`` (B, Se, d): (B, Se, KV, hd) each."""
        return project(enc_out, attn_params["wk"]), project(enc_out, attn_params["wv"])

    def _encoder_layer(self, lp, x, pos):
        h = L.apply_norm(lp["ln1"], x)
        a, _ = apply_attention(lp["attn"], self.cfg, h, pos, impl=self.attn_impl,
                               causal=False)
        x = x + a
        h = L.apply_norm(lp["ln2"], x)
        return x + L.apply_mlp(lp["mlp"], h)

    def _run_encoder(self, params, enc_embeds):
        """The bidirectional encoder over ``enc_embeds`` (B, Se, d), cast to
        the model dtype, at positions 0..Se-1; ends with ``enc_ln``."""
        x = enc_embeds.to(self.dtype)
        B, Se = x.shape[:2]
        pos = torch.arange(Se, device=x.device).expand(B, Se)
        for li in range(self.cfg.enc_layers):
            x = _remat(self._encoder_layer, self.remat,
                       layer_params(params["encoder"], li), x, pos)
        return L.apply_norm(params["enc_ln"], x)

    def _backbone(self, params, batch):
        """Embeddings and the decoder stack without a cache (after the
        encoder in the encdec family): (x, aux)."""
        x, pos = self._embed_inputs(params, batch)
        enc_out = enc_len = None
        if self.family == "encdec":
            enc_out = self._run_encoder(params, batch["enc_embeds"])
            enc_len = enc_out.shape[1]
        x, _, aux = self._run_decoder_stack(params, x, pos, None, None, enc_out, enc_len)
        return x, aux

    # -- public entry points ------------------------------------------------------
    def train_loss(self, params, batch) -> torch.Tensor:
        """Teacher-forced cross entropy over the padded vocab, averaged over
        ``batch["loss_mask"]`` where given; in the moe family plus 0.01 x the
        load-balance loss averaged over the layers."""
        x, aux = self._backbone(params, batch)
        x = L.apply_norm(params["final_ln"], x)
        logits = L.logits_from(params["embed"], x)
        loss = cross_entropy(logits, batch["targets"], batch.get("loss_mask"))
        if aux is not None:
            loss = loss + 0.01 * aux / self.cfg.n_layers
        return loss

    def prefill_logits(self, params, batch) -> torch.Tensor:
        x, _ = self._backbone(params, batch)
        x = L.apply_norm(params["final_ln"], x[:, -1:])
        return L.logits_from(params["embed"], x)[:, 0]

    def decode_step(self, params, batch, cache) -> Tuple[torch.Tensor, Any]:
        """One step for every sequence over the cache (split attention caches,
        recurrent states).  The cache's tensors are written in place; the
        returned dict shares them and carries the advanced lengths."""
        x, pos = self._embed_inputs(params, batch)
        split = "len_rec" in cache
        cache_len = (cache["len"], cache["len_rec"]) if split else cache["len"]
        x, _, _ = self._run_decoder_stack(params, x, pos, cache["layers"], cache_len,
                                          enc_len=cache.get("enc_len"))
        x = L.apply_norm(params["final_ln"], x[:, -1:])
        logits = L.logits_from(params["embed"], x)[:, 0]
        new_cache = dict(cache)
        S = batch["tokens"].shape[1]
        if split:
            new_cache["len_rec"] = cache["len_rec"] + S
        else:
            new_cache["len"] = cache["len"] + S
        return logits, new_cache

    def flush_cache(self, cache) -> Dict:
        """Recent -> main flush: the ``len_rec`` tokens of each split attention
        cache's recent ring are written into its main store after the ``len``
        tokens there, in place, and the ring is zeroed.  The reference writes
        the whole ring (R rows) and lets ``dynamic_update_slice`` clamp where
        that overflows the store, which overwrites cached tokens (ROADMAP.md,
        fault 5); this writes only the tokens the ring holds, and raises if
        they do not fit."""
        if "len_rec" not in cache:
            return cache
        len_main, len_rec = cache["len"], cache["len_rec"]
        layers = cache["layers"]
        nodes = [layers] if "main" in layers else [
            v for v in layers.values() if isinstance(v, dict) and "main" in v]
        for node in nodes:
            for main, recent in zip(node["main"], node["recent"]):
                if len_main + len_rec > main.shape[2]:
                    raise ValueError(
                        f"flush of {len_rec} tokens after {len_main} overflows the "
                        f"main store of {main.shape[2]}")
                main[:, :, len_main:len_main + len_rec] = recent[:, :, :len_rec].to(main.dtype)
                recent.zero_()
        new_cache = dict(cache)
        new_cache["len"] = len_main + len_rec
        new_cache["len_rec"] = 0
        return new_cache

    # -- caches ---------------------------------------------------------------------
    def init_cache(
        self, batch_size: int, max_len: int, enc_len: int = 0, recent_size: int = 256, *,
        device="cuda",
    ) -> Dict:
        """Dense, moe and vlm families: the split cache, ``main`` (read-only store) and
        ``recent`` (the ring new tokens land in), each ``(L, B, len, KV,
        hd)``.  ssm: the stacked RWKV states.  hybrid: the stacked Mamba
        states and one split cache per application of the shared block.
        encdec: the split cache under ``"self"`` and the decoder layers'
        cross-attention K/V of ``enc_len`` encoder tokens under ``"cross"``
        (zeros: the caller fills them from ``_run_encoder`` and
        ``_encoder_kv``, as the reference's tests do).  Lengths are ints."""
        cfg = self.cfg
        device = resolve_device(device)
        kv_dt = torch_dtype(cfg.kv_cache_dtype)

        def kv(n_stack, length):
            shape = (n_stack, batch_size, length, cfg.n_kv_heads, cfg.hd)
            return (torch.zeros(shape, dtype=kv_dt, device=device),
                    torch.zeros(shape, dtype=kv_dt, device=device))

        def split_kv(n_stack):
            return {"main": kv(n_stack, max_len), "recent": kv(n_stack, recent_size)}

        def stacked(state):
            """One state per layer: the given (meta) state's leaves, stacked."""
            return type(state)(*(
                torch.zeros((cfg.n_layers,) + t.shape, dtype=t.dtype, device=device)
                for t in state))

        if self.family == "ssm":
            st = R6.init_rwkv_state(cfg, batch_size, self.dtype, device="meta")
            return {"layers": stacked(st), "len": 0}
        if self.family == "hybrid":
            st = M2.init_mamba_state(cfg, batch_size, self.dtype, device="meta")
            return {
                "layers": {"mamba": stacked(st),
                           "attn": split_kv(cfg.n_layers // cfg.attn_every)},
                "len": 0,
                "len_rec": 0,
            }
        if self.family == "encdec":
            return {"layers": {"self": split_kv(cfg.n_layers), "cross": kv(cfg.n_layers, enc_len)},
                    "len": 0, "len_rec": 0, "enc_len": enc_len}
        return {"layers": split_kv(cfg.n_layers), "len": 0, "len_rec": 0}
