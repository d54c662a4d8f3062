"""Multi-rank runs for tests/test_torch_dist.py: each rank is its own
process on the CPU, joined by gloo through a rendezvous file in the test's
own directory (so parallel test workers never meet).

``run_ranks(case, world, workdir, timeout, **args)`` starts ``world``
processes of this file, waits at most ``timeout`` seconds for all of them,
kills any still running, and raises with every rank's exit code and the
tail of its output (a traceback) unless all exited 0.  A rank that dies
therefore fails the test instead of hanging it.  Each case writes its
results to ``out<rank>.pt`` in ``workdir``; the caller reads them.

Imports neither JAX nor the reference: the test process computes the
reference's values and hands inputs over as files.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_ranks(case: str, world: int, workdir, timeout: float = 60.0, **args) -> list:
    workdir = pathlib.Path(workdir)
    (workdir / "args.json").write_text(json.dumps(args))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, case, str(r), str(world), str(workdir)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)), log))
    deadline = time.monotonic() + timeout
    for p, _ in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            break
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    codes = [p.returncode for p, _ in procs]
    if any(codes):
        report = []
        for r, code in enumerate(codes):
            tail = (workdir / f"rank{r}.log").read_text()[-2000:]
            report.append(f"--- rank {r}: exit {code}"
                          f"{' (killed at the time limit)' if code == -9 else ''}\n{tail}")
        raise AssertionError(f"{case} on {world} ranks:\n" + "\n".join(report))
    import torch
    return [torch.load(workdir / f"out{r}.pt", weights_only=False) for r in range(world)]


# -- the rank side ------------------------------------------------------------------

def _full(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def case_moe(mesh, args, workdir):
    """The MoE layer under the mesh: out, aux and the gradients of x and
    every weight for the cotangents (gout, gaux)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import moe
    from repro_torch.models.params import spec_tree

    cfg = get_config(args["arch"]).smoke()
    inp = torch.load(workdir / "inputs.pt")
    specs = spec_tree(moe.moe_defs(cfg))
    p = shd.device_put({k: inp[k] for k in specs}, shd.shardings_for(specs, inp, mesh))
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = shd.device_put(inp["x"], shd.Sharding(mesh, shd.filter_spec(
        shd.P("data"), inp["x"].shape, mesh))).requires_grad_()
    with shd.use_mesh(mesh), shd.spmd():
        out, aux = moe.apply_moe(p, cfg, x)
        loss = (out * inp["gout"]).sum() + inp["gaux"] * aux
        loss.backward()
    res = {"out": _full(out), "aux": _full(aux), "x": _full(x.grad)}
    res.update({k: _full(v.grad) for k, v in p.items()})
    res["placements"] = {k: repr(v.placements) for k, v in p.items()}
    return res


def _vocab_rows_mode(widths, d):
    """A dispatch mode that keeps the most rows of any local op result as
    wide as the vocab (``widths``: whole, or one rank's slice), the (d,
    vocab) weights and their gradients apart: how many tokens' logits a
    rank holds.  It lets DTensor issue its local ops first, and skips its
    shape propagation (global shapes, on fake tensors), as
    ``hlo_stats.OpRecorder`` does."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class VocabRows(TorchDispatchMode):
        rows = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is None:
                for t in _pytree.tree_leaves(out):
                    if (isinstance(t, torch.Tensor) and t.dim() >= 2 and t.shape[-1] in widths
                            and tuple(t.shape[:-1]) != (d,)):
                        self.rows = max(self.rows, t.numel() // t.shape[-1])
            return out

    return VocabRows()


def _spy_attention_heads():
    """Wrap the local chunked attention so that it keeps the query heads
    each call was given (a rank's own, inside ``shard_map``)."""
    from repro_torch.models import attention

    heads, inner = [], attention._chunked_attention

    def spy(q, *a, **kw):
        heads.append(q.shape[2])
        return inner(q, *a, **kw)

    attention._chunked_attention = spy
    return heads


def case_train(mesh, args, workdir):
    """One train step of ``build_train_step`` under the mesh from the given
    params and batch: the loss, the grad norm and every param after it;
    and how the loss and its gradients split the work: the query heads of
    each local attention call and the most rows of vocab-wide logits on
    this rank."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.inputs import batch_shardings
    from repro_torch.models.layers import pad_vocab
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import build_train_step, value_and_grad
    from repro_torch.tree import tree_map

    cfg = get_config(args["arch"]).smoke()
    model = LM(cfg, attn_impl=args["attn"], remat=args["remat"])
    inp = torch.load(workdir / "inputs.pt")
    heads = _spy_attention_heads()
    vocab = pad_vocab(cfg)
    rows = _vocab_rows_mode({vocab, vocab // mesh.size(mesh.mesh_dim_names.index("model"))},
                            cfg.d_model)
    with shd.use_mesh(mesh):
        params = shd.device_put(inp["params"],
                                shd.shardings_for(model.param_specs(), inp["params"], mesh))
        batch = shd.device_put(inp["batch"], batch_shardings(inp["batch"], mesh))
        with shd.spmd(), rows:
            _, grads = value_and_grad(model.train_loss, params, batch)
        step = build_train_step(model, AdamWConfig(**args["opt"]))
        params, _, metrics = step(params, init_opt_state(params), batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": tree_map(_full, grads), "params": tree_map(_full, params),
            "placements": {k: repr(v.placements) for k, v in params["embed"].items()},
            "q_heads": sorted(set(heads)), "vocab_rows": rows.rows}


def _spy_columns(module):
    """Wrap ``module.column_parallel`` so that it keeps, for each call that
    returns a DTensor, (the product's columns, those of the rank's shard)."""
    cols, inner = [], module.column_parallel

    def spy(x, w):
        out = inner(x, w)
        if hasattr(out, "to_local"):
            cols.append((w.shape[1], out.to_local().shape[-1]))
        return out

    module.column_parallel = spy
    return cols


def _spy_ring_positions():
    """Wrap the segment attention so that it keeps the positions each call
    on a rank's local tensors attends to (the recent ring's slices inside
    ``shard_map``; the main segment runs on DTensors)."""
    from repro_torch.models import attention

    widths, inner = [], attention._attention_with_lse

    def spy(q, k, v, **kw):
        if not hasattr(k, "to_local"):
            widths.append(k.shape[1])
        return inner(q, k, v, **kw)

    attention._attention_with_lse = spy
    return widths


def _spy_decay_heads(*modules):
    """Wrap each block module's chunked form and step (the functions its
    blocks hand to ``linear_scan.chunked_on_shards`` / ``step_on_shards``)
    so that they keep, for each call, the module, the form, whether q was a
    DTensor and the heads it held (a rank's own, inside ``shard_map``)."""
    calls = []

    def wrap(module, name):
        inner = getattr(module, name)
        block = module.__name__.rsplit(".", 1)[-1]

        def spy(q, *a, **kw):
            calls.append((block, name, hasattr(q, "to_local"), q.shape[-2]))
            return inner(q, *a, **kw)

        setattr(module, name, spy)

    for m in modules:
        wrap(m, "chunked_decay_attention")
        wrap(m, "decay_attention_step")
    return calls


#: the repaired sharded paths' inputs: the smoke granite_moe_1b_a400m's
#: widths (4 query heads on 2 KV, d 128, vocab padded to 2048)
PATHS_ARCH = "granite_moe_1b_a400m"
#: the decode steps over a split cache (port faults F10, F11): smoke
#: stablelm_1_6b (4 KV heads) and qwen2_vl_72b (2 KV heads, "model" 4 does
#: not divide them); batch 4, 32 tokens in the main store, 5 in a ring of 16
DECODE_ARCHS = ("stablelm_1_6b", "qwen2_vl_72b")
DECODE_B, DECODE_MAIN, DECODE_RING, DECODE_LEN_REC = 4, 32, 16, 5
#: the rwkv6 channel mix (port fault F9): (batch, seq) of a sequence, a
#: decode step and a decode step of one sequence
CHANNEL_MIX_SHAPES = {"seq": (4, 32), "step": (4, 1), "one": (1, 1)}
#: the state path's blocks (port fault F14): the smoke zamba2_7b's Mamba2
#: block and rwkv6_7b's time mix, over a ragged sequence (not a multiple of
#: the 32-token chunk) from a state, then a decode step from the state it
#: leaves
STATE_BLOCKS = ("mamba", "time_mix")
STATE_B, STATE_S = 4, 40


def paths_inputs(seed: int = 0, B: int = 4, S: int = 32) -> dict:
    """Seeded inputs of ``case_paths``: x, a head and a table, targets and
    tokens drawn over the whole padded vocab (so every rank's vocab slice
    holds some), a 0/1 loss mask; attention's q, k and v; the cotangents."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.layers import pad_vocab

    cfg = get_config(PATHS_ARCH).smoke()
    V, d, H, KV, hd = pad_vocab(cfg), cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    return {"x": normal(B, S, d), "head": normal(d, V, scale=0.05),
            "tok": normal(V, d, scale=0.05),
            "targets": torch.from_numpy(rng.integers(0, V, size=(B, S))),
            "mask": torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.float32)),
            "q": normal(B, S, H, hd), "k": normal(B, S, KV, hd), "v": normal(B, S, KV, hd),
            "gattn": normal(B, S, H, hd),
            "tokens": torch.from_numpy(rng.integers(0, V, size=(B, S))),
            "gembed": normal(B, S, d)}


def split_inputs(seed: int = 0) -> dict:
    """Seeded inputs of ``case_split``: the recent ring's segment alone (one
    query a row at the ring's next position, its 5 tokens and the new
    one; the cotangents of out and lse), the channel mix, a split-cache
    decode step of each of ``DECODE_ARCHS``; and of ``case_mamba``, a
    Mamba2 decode step."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config

    cfg = get_config(PATHS_ARCH).smoke()
    B, H, KV, hd, R = DECODE_B, cfg.n_heads, cfg.n_kv_heads, cfg.hd, DECODE_RING
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    return {"ring": {"q": normal(B, 1, H, hd), "k": normal(B, R, KV, hd),
                     "v": normal(B, R, KV, hd), "gout": normal(B, 1, H, hd),
                     "glse": normal(B, 1, H)},
            "channel_mix": _channel_mix_inputs(normal),
            "decode": {arch: _decode_inputs(arch, normal, rng) for arch in DECODE_ARCHS},
            "mamba": _mamba_inputs(normal)}


def state_inputs(seed: int = 0) -> dict:
    """Seeded inputs of ``case_state``: for each of ``STATE_BLOCKS`` its
    smoke params (every leaf drawn), a state, the sequence's x and
    cotangents of its output and of the state it leaves, and the decode
    step's x."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mamba2, rwkv6
    from repro_torch.models.params import map_defs

    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    out = {}
    for block, arch, defs, init in (
            ("mamba", "zamba2_7b", mamba2.mamba_defs, mamba2.init_mamba_state),
            ("time_mix", "rwkv6_7b", rwkv6.time_mix_defs, rwkv6.init_rwkv_state)):
        cfg = get_config(arch).smoke()
        st = init(cfg, STATE_B, torch.float32, device="cpu")
        out[block] = {"params": map_defs(lambda d: normal(*d.shape, scale=0.1), defs(cfg)),
                      "state": {k: normal(*v.shape, scale=0.1) for k, v in st._asdict().items()},
                      "x": normal(STATE_B, STATE_S, cfg.d_model),
                      "gout": normal(STATE_B, STATE_S, cfg.d_model),
                      "gstate": normal(*st[-1].shape),
                      "x_step": normal(STATE_B, 1, cfg.d_model)}
    return out


def _state_paths(inp, put, mesh) -> dict:
    """Each of ``STATE_BLOCKS`` over the sequence from the given state with
    the gradients of x, the state and every param (the cotangents on the
    output and on the decay state it leaves), then a decode step from the
    state it left: the sequence's output, state and gradients, the step's
    output and state."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import mamba2, rwkv6
    from repro_torch.models.params import spec_tree

    out = {}
    for block, arch, defs in (("mamba", "zamba2_7b", mamba2.mamba_defs),
                              ("time_mix", "rwkv6_7b", rwkv6.time_mix_defs)):
        cfg = get_config(arch).smoke()
        b = inp[block]
        p = {k: v.clone() for k, v in b["params"].items()}
        if mesh is not None:
            p = shd.device_put(p, shd.shardings_for(spec_tree(defs(cfg)), p, mesh))
        p = {k: v.requires_grad_() for k, v in p.items()}
        x = put(b["x"]).requires_grad_()
        st = {k: put(v).requires_grad_() for k, v in b["state"].items()}
        if block == "mamba":
            y, new = mamba2.apply_mamba(p, cfg, x, mamba2.MambaState(**st))
            decay, keep = new.ssd, new
        else:
            y, (shift, decay) = rwkv6.apply_time_mix(p, cfg, x, rwkv6.RwkvState(**st))
            keep = rwkv6.RwkvState(shift, st["shift_cm"], decay)
        ((y * put(b["gout"])).sum() + (decay * put(b["gstate"])).sum()).backward()
        out[f"{block}/seq"] = {"out": _full(y), "state": _full(decay), "x": _full(x.grad),
                               **{f"state.{k}": _full(v.grad) for k, v in st.items()
                                  if v.grad is not None},
                               **{k: _full(v.grad) for k, v in p.items()}}
        keep = type(keep)(*(t.detach() for t in keep))
        with torch.no_grad():
            if block == "mamba":
                y, new = mamba2.apply_mamba(p, cfg, put(b["x_step"]), keep)
                states = new._asdict()
            else:
                y, (shift, decay) = rwkv6.apply_time_mix(p, cfg, put(b["x_step"]), keep)
                states = {"shift_tm": shift, "wkv": decay}
        out[f"{block}/step"] = {"out": _full(y), **{k: _full(v) for k, v in states.items()}}
    return out


def _channel_mix_inputs(normal) -> dict:
    """The smoke rwkv6_7b's channel-mix params (every leaf drawn, the
    token-shift mixes too), and for each of ``CHANNEL_MIX_SHAPES`` x, the
    previous token's row and the cotangent."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import rwkv6
    from repro_torch.models.params import map_defs

    cfg = get_config("rwkv6_7b").smoke()
    out = {"params": map_defs(lambda d: normal(*d.shape, scale=0.1),
                              rwkv6.channel_mix_defs(cfg))}
    for name, (B, S) in CHANNEL_MIX_SHAPES.items():
        out[name] = {"x": normal(B, S, cfg.d_model), "prev": normal(B, cfg.d_model),
                     "gout": normal(B, S, cfg.d_model)}
    return out


def _mamba_inputs(normal) -> dict:
    """The smoke zamba2_7b's Mamba2 params (every leaf drawn), and a decode
    step's x and state (conv, ssd)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mamba2
    from repro_torch.models.params import map_defs

    cfg = get_config("zamba2_7b").smoke()
    st = mamba2.init_mamba_state(cfg, DECODE_B, torch.float32, device="cpu")
    return {"params": map_defs(lambda d: normal(*d.shape, scale=0.1), mamba2.mamba_defs(cfg)),
            "step": {"x": normal(DECODE_B, 1, cfg.d_model), "conv": normal(*st.conv.shape),
                     "ssd": normal(*st.ssd.shape, scale=0.1)}}


def _decode_inputs(arch: str, normal, rng) -> dict:
    """``arch``'s smoke params, a split cache of random K/V with
    ``DECODE_MAIN`` tokens in the main store and ``DECODE_LEN_REC`` in the
    ring, and one decode step's tokens at the next position."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import LM

    cfg = get_config(arch).smoke()
    model = LM(cfg)
    cache = model.init_cache(DECODE_B, DECODE_MAIN, recent_size=DECODE_RING, device="cpu")
    layers = {k: tuple(normal(*t.shape) for t in v) for k, v in cache["layers"].items()}
    pos = torch.full((DECODE_B, 1), DECODE_MAIN + DECODE_LEN_REC, dtype=torch.int32)
    return {"params": model.init(int(rng.integers(1 << 16)), device="cpu"),
            "layers": layers,
            "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(DECODE_B, 1))).to(
                torch.int32),
            "positions": pos[..., None].expand(DECODE_B, 1, 3).contiguous()
            if cfg.rope == "mrope" else pos}


def _paths(inp, put) -> dict:
    """The three repaired paths and their gradients, each input placed by
    ``put(tensor, weight)`` (``weight`` names a table or head, None for an
    activation; a plain copy without a mesh): the loss (``nll_from`` and
    its masked mean, tied and untied, with and without the mask),
    attention split by query heads (chunked and naive), the token
    lookup."""
    import math

    import torch
    from repro_torch.models import attention
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import masked_mean

    out = {}
    for tied in (True, False):
        for masked in (False, True):
            x = put(inp["x"]).requires_grad_()
            name = "tok" if tied else "head"
            w = put(inp[name], name).requires_grad_()
            p = {"tok": w} if tied else {"tok": put(inp["tok"], "tok"), "head": w}
            loss = masked_mean(L.nll_from(p, x, put(inp["targets"])),
                               put(inp["mask"]) if masked else None)
            loss.backward()
            out[f"loss/{'tied' if tied else 'untied'}/{'mask' if masked else 'all'}"] = {
                "loss": _full(loss), "x": _full(x.grad), "w": _full(w.grad)}
    for impl in ("chunked", "naive"):
        q, k, v = (put(inp[n]).requires_grad_() for n in "qkv")
        o = attention._inner_attention(q, k, v, impl=impl, causal=True, kv_len=q.shape[1],
                                       scale=1 / math.sqrt(q.shape[-1]))
        (o * put(inp["gattn"])).sum().backward()
        out[f"attention/{impl}"] = {"out": _full(o), "q": _full(q.grad), "k": _full(k.grad),
                                    "v": _full(v.grad)}
    tok = put(inp["tok"], "tok").requires_grad_()
    e = L.embed_tokens({"tok": tok}, put(inp["tokens"]), torch.float32)
    (e * put(inp["gembed"])).sum().backward()
    out["lookup"] = {"out": _full(e), "tok": _full(tok.grad)}
    return out


def _split_paths(inp, put, mesh=None) -> dict:
    """The paths repaired for port faults F9-F11, each input placed by
    ``put`` as in ``_paths`` and the models' params and caches by their own
    specs on ``mesh``: the rwkv6 channel mix at each of
    ``CHANNEL_MIX_SHAPES`` with its gradients, the recent ring's segment
    with its gradients, a decode step over a split cache of each of
    ``DECODE_ARCHS`` (its output and the ring it writes; qwen2_vl_72b's
    first layer alone: through all its layers the no-mesh step's own f32
    rounding is 8e-5 from a float64 step, as at depth under the reference's
    init, ROADMAP.md fault 4)."""
    import math

    import torch
    from repro_torch.models import attention

    out = _channel_mix_paths(inp["channel_mix"], put, mesh)
    ring = inp["ring"]
    q, k, v = (put(ring[n]).requires_grad_() for n in "qkv")
    pos = torch.full((k.shape[0], 1), DECODE_MAIN + DECODE_LEN_REC, dtype=torch.int32)
    o, lse = attention._ring_segment(q, k, v, kv_len=DECODE_LEN_REC + 1, kv_offset=DECODE_MAIN,
                                     scale=1 / math.sqrt(q.shape[-1]), q_pos=put(pos))
    ((o * put(ring["gout"])).sum() + (lse * put(ring["glse"])).sum()).backward()
    out["ring"] = {"out": _full(o), "lse": _full(lse), "q": _full(q.grad), "k": _full(k.grad),
                   "v": _full(v.grad)}
    out["decode/stablelm_1_6b"] = _decode_path("stablelm_1_6b", inp["decode"]["stablelm_1_6b"],
                                                mesh)
    out["decode/qwen2_vl_72b"] = _decode_path("qwen2_vl_72b", inp["decode"]["qwen2_vl_72b"], mesh,
                                              layer=0)
    return out


def _channel_mix_paths(inp, put, mesh) -> dict:
    """``rwkv6.apply_channel_mix`` at each shape, with the previous token's
    row: its output and the gradients of x and every param."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import rwkv6
    from repro_torch.models.params import spec_tree

    cfg = get_config("rwkv6_7b").smoke()
    specs = spec_tree(rwkv6.channel_mix_defs(cfg))
    out = {}
    for name in CHANNEL_MIX_SHAPES:
        p = {k: v.clone() for k, v in inp["params"].items()}
        if mesh is not None:
            p = shd.device_put(p, shd.shardings_for(specs, p, mesh))
        p = {k: v.requires_grad_() for k, v in p.items()}
        x = put(inp[name]["x"]).requires_grad_()
        y, _ = rwkv6.apply_channel_mix(p, cfg, x, put(inp[name]["prev"]))
        (y * put(inp[name]["gout"])).sum().backward()
        out[f"channel_mix/{name}"] = {"out": _full(y), "x": _full(x.grad),
                                      **{k: _full(v.grad) for k, v in p.items()}}
    return out


def _mamba_paths(inp, put, mesh) -> dict:
    """``mamba2.apply_mamba``'s decode step from the given state: its output
    and the new state (the products' gradients are the channel mix's
    case)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.models import mamba2
    from repro_torch.models.params import spec_tree

    cfg = get_config("zamba2_7b").smoke()
    p = {k: v.clone() for k, v in inp["params"].items()}
    if mesh is not None:
        p = shd.device_put(p, shd.shardings_for(spec_tree(mamba2.mamba_defs(cfg)), p, mesh))
    step = inp["step"]
    state = mamba2.MambaState(conv=put(step["conv"]), ssd=put(step["ssd"]))
    with torch.no_grad():
        y, new = mamba2.apply_mamba(p, cfg, put(step["x"]), state)
    return {"mamba/step": {"out": _full(y), "conv": _full(new.conv), "ssd": _full(new.ssd)}}


def _decode_path(arch, inp, mesh, layer=None) -> dict:
    """One ``LM.decode_step`` over the split cache: the logits and the
    recent ring it wrote (K and V of every layer).  With ``layer``, that
    layer's attention alone over its cache, on the token embeddings: its
    output and the ring it wrote."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.inputs import batch_shardings
    from repro_torch.models.attention import apply_attention
    from repro_torch.models.transformer import LM, layer_params

    model = LM(get_config(arch).smoke())
    params = inp["params"]
    layers = {k: tuple(t.clone() for t in v) for k, v in inp["layers"].items()}
    batch = {"tokens": inp["tokens"], "positions": inp["positions"]}
    if mesh is not None:
        params = shd.device_put(params, shd.shardings_for(model.param_specs(), params, mesh))
        layers = shd.device_put(layers, shd.axes_to_shardings(
            model.cache_spec_axes()["layers"], layers, mesh))
        batch = shd.device_put(batch, batch_shardings(batch, mesh))
    cache = {"layers": layers, "len": DECODE_MAIN, "len_rec": DECODE_LEN_REC}
    with torch.no_grad():
        if layer is None:
            logits, new = model.decode_step(params, batch, cache)
            rk, rv = new["layers"]["recent"]
            return {"logits": _full(logits), "ring_k": _full(rk), "ring_v": _full(rv)}
        with shd.spmd():
            x, pos = model._embed_inputs(params, batch)
            out, new = apply_attention(layer_params(params["layers"], layer)["attn"], model.cfg,
                                       x, pos, cache=layer_params(layers, layer),
                                       cache_len=(DECODE_MAIN, DECODE_LEN_REC))
    rk, rv = new["recent"]
    return {"out": _full(out), "ring_k": _full(rk), "ring_v": _full(rv)}


def paths_local(inp) -> dict:
    """``_paths`` without a mesh."""
    return _paths(inp, lambda t, weight=None: t.clone())


def split_local(inp) -> dict:
    """``_split_paths`` without a mesh."""
    return _split_paths(inp, lambda t, weight=None: t.clone())


def mamba_local(inp) -> dict:
    """``_mamba_paths`` of ``split_inputs()["mamba"]`` without a mesh."""
    return _mamba_paths(inp["mamba"], lambda t, weight=None: t.clone(), None)


def state_local(inp) -> dict:
    """``_state_paths`` without a mesh, as it runs (float32) and in float64
    (the inputs and params cast, the code's own float32 casts kept: the
    decay math, the norms): ``{"f32": ..., "f64": ...}``.  The float64 run is
    the referee of gradients that float32 cannot give to 1e-5 of their
    largest in any reduction order: over these inputs the float32 no-mesh
    path's gradient of the time mix's mu_r is 1.6e-5 of its largest from
    it, the (2, 4) mesh's 2.9e-6."""
    from repro_torch.tree import tree_map

    def run(cast):
        return _state_paths(tree_map(cast, inp), lambda t, weight=None: t.clone(), None)

    return {"f32": run(lambda t: t),
            "f64": run(lambda t: t.double() if t.is_floating_point() else t)}


def state_close(mine: dict, local: dict, tol: float) -> float:
    """The largest of ``mine``'s distances from the float64 no-mesh run
    less the float32 no-mesh run's own, each over max(1, the output's
    largest), over every output of every path; asserts it is at most
    ``tol``: the mesh is no farther from float64 than the float32 path
    without a mesh, beyond ``tol`` of each output's largest."""
    worst = 0.0
    for path, vals in local["f64"].items():
        for k, v in vals.items():
            f32 = local["f32"][path][k]
            scale = max(1.0, float(f32.abs().max()))
            own = float((f32.double() - v).abs().max())
            err = (float((mine[path][k].double() - v).abs().max()) - own) / scale
            assert err <= tol, f"{path} {k}: {err:.3e} of {scale:.3f} beyond the f32 path's {own:.3e}"
            worst = max(worst, err)
    return worst


def _put_on(mesh):
    """``put`` for ``_paths`` under the mesh: the weights placed as the
    model's params ("embed" over "data", the vocab over "model"), every
    activation, target and mask split by batch."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist import sharding as shd

    specs = {"head": shd.P("data", "model"), "tok": shd.P("model", "data"), None: shd.P("data")}

    def put(t, weight=None):
        spec = shd.filter_spec(specs[weight], t.shape, mesh)
        return distribute_tensor(t.clone(), mesh, shd.placements_for(spec, mesh))

    return put


def _nll_before(p, x, targets):
    """``layers.nll_from`` under a mesh as it was before its loss became one
    autograd function (port fault P2): the same ops on the f32 copy of the
    logits under autograd, kept to hold the function's loss bit-equal."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.models import layers as L

    mesh = shd.get_mesh()
    vocab = shd.logical_spec("vocab")[0]
    key, vdim = ("head", 1) if "head" in p else ("tok", 0)
    w_spec = shd.filter_spec(shd.P(None, vocab) if vdim else shd.P(vocab, None), p[key].shape,
                             mesh)
    axis = L._vocab_axis(w_spec, vdim)
    batch = shd.filter_spec(shd.logical_spec("batch"), x.shape[:1], mesh)[0]

    def local(xl, w, t):
        logits = L.logits_from({key: w}, xl).float()
        vl = logits.shape[-1]
        m = shd.all_gather(logits.detach().amax(-1, keepdim=True), axis, 2).amax(-1)
        lse = torch.log(shd.psum(torch.exp(logits - m[..., None]).sum(-1), axis)) + m
        i = t.long() - shd.axis_index(axis) * vl
        ll = torch.gather(logits, -1, i.clamp(0, vl - 1)[..., None])[..., 0]
        return lse - shd.psum(torch.where((i >= 0) & (i < vl), ll, 0.0), axis)

    return shd.shard_map(local, mesh=mesh,
                         in_specs=(shd.P(batch, None, None), w_spec, shd.P(batch, None)),
                         out_specs=shd.P(batch, None))(x, p[key], targets)


def _loss_checks(inp, put) -> dict:
    """The vocab-parallel loss (port fault P2) against ``_nll_before``, tied
    and untied, bit for bit; and in bfloat16 (x and the head), the (dtype,
    shape) of every tensor autograd saves for the loss's backward (a
    DTensor's global shape; inside ``shard_map``, the rank's)."""
    import torch
    from repro_torch.models import layers as L

    out = {}
    for tied in (True, False):
        name = "tok" if tied else "head"
        p = {"tok": put(inp["tok"], "tok")}
        if not tied:
            p["head"] = put(inp["head"], "head")
        x, t = put(inp["x"]), put(inp["targets"])
        with torch.no_grad():
            mine, before = L.nll_from(p, x, t), _nll_before(p, x, t)
        out[f"bit_equal/{name}"] = bool(torch.equal(_full(mine), _full(before)))
    saved = []

    def pack(t):
        saved.append((str(t.dtype), tuple(t.shape)))
        return t

    x = put(inp["x"].bfloat16()).requires_grad_()
    head = put(inp["head"].bfloat16(), "head").requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = L.nll_from({"tok": put(inp["tok"].bfloat16(), "tok"), "head": head}, x,
                          put(inp["targets"])).mean()
    loss.backward()
    out["saved"] = saved
    return out


def case_paths(mesh, args, workdir):
    """``_paths`` under the mesh (``_put_on``), the query heads of each
    local attention call, and ``_loss_checks``."""
    import torch
    from repro_torch.dist import sharding as shd

    inp = torch.load(workdir / "inputs.pt")
    heads = _spy_attention_heads()
    with shd.use_mesh(mesh), shd.spmd():
        out = _paths(inp, _put_on(mesh))
        out["loss_checks"] = _loss_checks(inp, _put_on(mesh))
    out["q_heads"] = sorted(set(heads))
    return out


def case_split(mesh, args, workdir):
    """``_split_paths`` under the mesh, and the rank's share of the work:
    the ring positions each local segment attends to, and (all columns,
    the rank's) of the channel mix's receptance and of every attention
    projection."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.models import attention, rwkv6

    inp = torch.load(workdir / "inputs.pt")
    ring = _spy_ring_positions()
    cols = {k: _spy_columns(m) for k, m in (("receptance_columns", rwkv6),
                                            ("projection_columns", attention))}
    with shd.use_mesh(mesh), shd.spmd():
        out = _split_paths(inp, _put_on(mesh), mesh)
    out["ring_positions"] = sorted(set(ring))
    out.update({k: sorted(set(v)) for k, v in cols.items()})
    return out


def case_state(mesh, args, workdir):
    """``_state_paths`` (port fault F14) under the mesh, and each call of the
    decay math: its name, whether q was a DTensor, and its heads."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.models import mamba2, rwkv6

    inp = torch.load(workdir / "inputs.pt")
    calls = _spy_decay_heads(mamba2, rwkv6)
    with shd.use_mesh(mesh), shd.spmd():
        out = _state_paths(inp, _put_on(mesh), mesh)
    out["decay_calls"] = sorted(set(calls))
    return out


def case_mamba(mesh, args, workdir):
    """``_mamba_paths`` (port fault F12) under the mesh, and (all columns,
    the rank's) of Mamba2's B, C and dt."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.models import mamba2

    inp = torch.load(workdir / "inputs.pt")
    cols = _spy_columns(mamba2)
    with shd.use_mesh(mesh), shd.spmd():
        out = _mamba_paths(inp["mamba"], _put_on(mesh), mesh)
    out["mamba_columns"] = sorted(set(cols))
    return out


def case_psum(mesh, args, workdir):
    """``compressed_psum`` of each rank's seeded input over "data"."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.optim.compression import compressed_psum

    rank = dist.get_rank()
    x = torch.from_numpy(np.random.default_rng(rank).normal(size=(8, 128)).astype(np.float32))
    with shd.use_mesh(mesh):
        return {"x": x, "out": compressed_psum(x, "data")}


def case_restore(mesh, args, workdir):
    """``ckpt.restore(shardings=)`` of the checkpoint the test wrote."""
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.dist import sharding as shd

    like = torch.load(workdir / "inputs.pt")
    specs = {k: shd.P(*v) for k, v in args["specs"].items()}
    out = ckpt.restore(args["ckpt"], 0, like, shd.shardings_for(specs, like, mesh))
    return {k: {"full": _full(v), "placements": repr(v.placements),
                "local_shape": tuple(v.to_local().shape)} for k, v in out.items()}


def case_trainer(mesh, args, workdir):
    """The ``Trainer`` under the mesh (the ``launch.train --full`` path under
    ``torchrun``): ``steps`` steps with a checkpoint every 2, then a second
    trainer that resumes from the last one and takes one more step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args["arch"]).smoke()
    model = LM(cfg, attn_impl="chunked", remat="full")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args["seq"], batch_per_shard=args["batch"])
    ocfg = AdamWConfig(**args["opt"])
    runs = []
    with shd.use_mesh(mesh):
        for steps in (args["steps"], args["steps"] + 1):
            tcfg = TrainerConfig(total_steps=steps, ckpt_every=2, ckpt_dir=str(workdir / "ck"),
                                 log_every=1000)
            out = Trainer(model, data, ocfg, tcfg, device="cpu", mesh=mesh,
                          log=lambda line: None).run()
            runs.append([(s, m["loss"]) for s, m in out["history"]])
    return {"runs": runs, "placement": repr(out["params"]["embed"]["tok"].placements)}


CASES = {"moe": case_moe, "train": case_train, "psum": case_psum, "restore": case_restore,
         "trainer": case_trainer, "paths": case_paths, "split": case_split,
         "mamba": case_mamba, "state": case_state}


def main() -> None:
    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    workdir = pathlib.Path(workdir)
    args = json.loads((workdir / "args.json").read_text())
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh_compat

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rdv'}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh_compat(args["mesh"], args["axes"], "cpu")
        res = CASES[case](mesh, args, workdir)
        torch.save(res, workdir / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
