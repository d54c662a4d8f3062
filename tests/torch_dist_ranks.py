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


#: the repaired sharded paths' inputs: the smoke granite_moe_1b_a400m's
#: widths (4 query heads on 2 KV, d 128, vocab padded to 2048)
PATHS_ARCH = "granite_moe_1b_a400m"


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


def paths_local(inp) -> dict:
    """``_paths`` without a mesh."""
    return _paths(inp, lambda t, weight=None: t.clone())


def case_paths(mesh, args, workdir):
    """``_paths`` under the mesh: the weights placed as the model's params
    ("embed" over "data", the vocab over "model"), every activation, target
    and mask split by batch."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist import sharding as shd

    inp = torch.load(workdir / "inputs.pt")
    specs = {"head": shd.P("data", "model"), "tok": shd.P("model", "data"), None: shd.P("data")}

    def put(t, weight=None):
        spec = shd.filter_spec(specs[weight], t.shape, mesh)
        return distribute_tensor(t.clone(), mesh, shd.placements_for(spec, mesh))

    heads = _spy_attention_heads()
    with shd.use_mesh(mesh), shd.spmd():
        out = _paths(inp, put)
    out["q_heads"] = sorted(set(heads))
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
         "trainer": case_trainer, "paths": case_paths}


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
