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


def case_train(mesh, args, workdir):
    """One train step of ``build_train_step`` under the mesh from the given
    params and batch: the loss, the grad norm and every param after it."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.inputs import batch_shardings
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import build_train_step, value_and_grad
    from repro_torch.tree import tree_map

    cfg = get_config(args["arch"]).smoke()
    model = LM(cfg, attn_impl=args["attn"], remat=args["remat"])
    inp = torch.load(workdir / "inputs.pt")
    with shd.use_mesh(mesh):
        params = shd.device_put(inp["params"],
                                shd.shardings_for(model.param_specs(), inp["params"], mesh))
        batch = shd.device_put(inp["batch"], batch_shardings(inp["batch"], mesh))
        with shd.spmd():
            _, grads = value_and_grad(model.train_loss, params, batch)
        step = build_train_step(model, AdamWConfig(**args["opt"]))
        params, _, metrics = step(params, init_opt_state(params), batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": tree_map(_full, grads), "params": tree_map(_full, params),
            "placements": {k: repr(v.placements) for k, v in params["embed"].items()}}


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
         "trainer": case_trainer}


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
