"""The multi-rank cases of ``tests/torch_dist_ranks.py`` on this machine's
PyTorch over gloo, held against the port's own local path (no JAX), so the
sharded code can be checked where the tests cannot run: the card's machine
has another PyTorch, whose DTensor has fewer sharding rules.

    PYTHONPATH=src python scripts/torch_dist_probe.py

Each case spawns its ranks as CPU processes (1-8) under a time limit and
prints one line: the MoE layer on (1, 1) and (2, 4) meshes (max abs diff of
out, aux and every gradient from the local path on each data shard), the
train step of the smoke granite_moe_1b_a400m on (2, 4) and stablelm_1_6b on
(1, 2) (the loss against the no-mesh loss on the data shards' batches,
the query heads of each rank's local attention and the most rows of
vocab-wide logits a rank held), the paths repaired for port faults F6-F8
("paths": the vocab-parallel loss tied and untied, with the mask and
without; attention split by query heads, chunked and naive; the
vocab-parallel token lookup) and F9-F11 ("split": the smoke rwkv6_7b's
channel mix at three shapes; the recent ring's segment split over
"model"; a split-cache decode step of the smoke stablelm_1_6b and
qwen2_vl_72b's first attention layer; the ring positions and the
receptance and projection columns a rank takes, its share of "model"),
each on (2, 4) and (1, 4) meshes: max abs diff of each output and
gradient from the no-mesh path, held to 1e-5 of max(1, its largest);
F14 ("state": the smoke zamba2_7b's Mamba2 block and rwkv6_7b's time mix
over a ragged 40-token sequence from a state with the gradients of x, the
state and every param, then a decode step; the decay math's calls, each
on plain tensors of the rank's heads) on the same meshes: each output's
max abs diff from the float32 no-mesh path over max(1, its largest), held
to 1e-5 beyond that path's own distance from a float64 run
(``torch_dist_ranks.state_close``); ``compressed_psum`` on 4 ranks,
``restore(shardings=)`` on 2 and the ``Trainer`` under a (1, 2) mesh.
Exits 1 if a case fails."""
from __future__ import annotations

import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_dist_ranks import (DECODE_RING, paths_inputs, paths_local, run_ranks,  # noqa: E402
                              split_inputs, split_local, state_close, state_inputs,
                              state_local)

from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import RunShape  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.inputs import make_batch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

OPT = dict(lr=3e-3, warmup_steps=1, total_steps=10)
MESH = ["data", "model"]


def moe_case(work, shape):
    cfg = get_config("granite_moe_1b_a400m").smoke()
    w = init_params(moe.moe_defs(cfg), dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32))
    gout = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    torch.save(dict(w, x=x, gout=gout, gaux=torch.tensor(0.7)), work / "inputs.pt")
    res = run_ranks("moe", shape[0] * shape[1], work, 120, arch="granite_moe_1b_a400m",
                    mesh=list(shape), axes=MESH)[0]
    ws = {k: v.clone().requires_grad_() for k, v in w.items()}
    xs = x.clone().requires_grad_()
    outs, auxs = zip(*(moe.apply_moe(ws, cfg, xb) for xb in xs.chunk(shape[0])))
    out, aux = torch.cat(outs), sum(auxs) / shape[0]
    ((out * gout).sum() + 0.7 * aux).backward()
    want = dict(out=out, aux=aux, x=xs.grad, **{k: v.grad for k, v in ws.items()})
    return {k: float((res[k] - v).abs().max()) for k, v in want.items()}


def train_case(work, arch, shape):
    cfg = get_config(arch).smoke()
    model = LM(cfg, attn_impl="chunked", remat="full")
    params = model.init(0, device="cpu")
    batch = make_batch(cfg, RunShape("t", 32, 4, "train"), device="cpu")
    torch.save({"params": params, "batch": batch}, work / "inputs.pt")
    res = run_ranks("train", shape[0] * shape[1], work, 180, arch=arch, mesh=list(shape),
                    axes=MESH, attn="chunked", remat="full", opt=OPT)[0]
    with torch.no_grad():
        local = float(np.mean([float(model.train_loss(
            params, {k: v.chunk(shape[0])[i] for k, v in batch.items()}))
            for i in range(shape[0])]))
    loss = res["metrics"]["loss"]
    return {"mesh": loss, "local": local, "relative": abs(loss - local) / abs(local),
            "q_heads": res["q_heads"], "vocab_rows": res["vocab_rows"]}


def _max_diffs(outs, want, tol):
    """Each path's max abs diff over the ranks from the no-mesh path, held
    to ``tol`` of max(1, its largest)."""
    errs = {}
    for path, vals in want.items():
        errs[path] = max(float((o[path][k] - v).abs().max()) for o in outs for k, v in vals.items())
        scale = max(float(v.abs().max()) for v in vals.values())
        assert errs[path] <= tol * max(1.0, scale), f"{path}: {errs[path]} from the local path"
    return errs


def paths_case(work, shape, tol=1e-5):
    inp = paths_inputs()
    torch.save(inp, work / "inputs.pt")
    outs = run_ranks("paths", shape[0] * shape[1], work, 180, mesh=list(shape), axes=MESH)
    errs = _max_diffs(outs, paths_local(inp), tol)
    return {"max_abs_diff": errs, "q_heads": outs[0]["q_heads"]}


def split_case(work, shape, tol=1e-5):
    inp = split_inputs()
    torch.save(inp, work / "inputs.pt")
    outs = run_ranks("split", shape[0] * shape[1], work, 180, mesh=list(shape), axes=MESH)
    errs = _max_diffs(outs, split_local(inp), tol)
    o = outs[0]
    assert o["ring_positions"] == [DECODE_RING // shape[1]], o["ring_positions"]
    split = ("receptance_columns", "projection_columns")
    columns = [c for k in split for c in o[k]]
    assert columns and all(n == shape[1] * mine for n, mine in columns), columns
    return {"max_abs_diff": errs, "ring_positions": o["ring_positions"],
            **{k: o[k] for k in split}}


def state_case(work, shape, tol=1e-5):
    inp = state_inputs()
    torch.save(inp, work / "inputs.pt")
    outs = run_ranks("state", shape[0] * shape[1], work, 180, mesh=list(shape), axes=MESH)
    local = state_local(inp)
    beyond = max(state_close(o, local, tol) for o in outs)
    rel = {}
    for path, vals in local["f32"].items():
        rel[path] = max(float((o[path][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
                        for o in outs for k, v in vals.items())
    calls = sorted({c for o in outs for c in o["decay_calls"]})
    assert not any(dtensor for _, _, dtensor, _ in calls), calls
    return {"max_rel_diff_from_f32": rel, "beyond_the_f32_path": beyond, "decay_calls": calls}


def psum_case(work):
    outs = run_ranks("psum", 4, work, 120, mesh=[4], axes=["data"])
    return {"max_abs_from_the_sum": float((outs[0]["out"] - sum(o["x"] for o in outs)).abs().max())}


def restore_case(work):
    tree = {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6)}
    ckpt.save(str(work / "ck"), 0, tree)
    torch.save(tree, work / "inputs.pt")
    res = run_ranks("restore", 2, work, 120, mesh=[2], axes=["data"], ckpt=str(work / "ck"),
                    specs={"w": ["data", None]})[0]
    return {"placements": res["w"]["placements"], "equal": torch.equal(res["w"]["full"], tree["w"])}


def trainer_case(work):
    res = run_ranks("trainer", 2, work, 180, mesh=[1, 2], axes=MESH, arch="stablelm_1_6b",
                    seq=16, batch=2, steps=3, opt=OPT)[0]
    return {"losses": res["runs"]}


CASES = [("moe 1x1", lambda w: moe_case(w, (1, 1))), ("moe 2x4", lambda w: moe_case(w, (2, 4))),
         ("train moe 2x4", lambda w: train_case(w, "granite_moe_1b_a400m", (2, 4))),
         ("train dense 1x2", lambda w: train_case(w, "stablelm_1_6b", (1, 2))),
         ("paths 2x4", lambda w: paths_case(w, (2, 4))),
         ("paths 1x4", lambda w: paths_case(w, (1, 4))),
         ("split 2x4", lambda w: split_case(w, (2, 4))),
         ("split 1x4", lambda w: split_case(w, (1, 4))),
         ("state 2x4", lambda w: state_case(w, (2, 4))),
         ("state 1x4", lambda w: state_case(w, (1, 4))),
         ("compressed_psum 4", psum_case), ("restore 2", restore_case),
         ("trainer 1x2", trainer_case)]


def main() -> int:
    torch.set_num_threads(2)
    failed = 0
    for name, fn in CASES:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            try:
                out = fn(pathlib.Path(work))
                print(f"[dist-probe] {name}: {out} ({time.perf_counter() - t0:.1f} s)", flush=True)
            except AssertionError as e:
                failed += 1
                print(f"[dist-probe] {name}: FAILED\n{e}", flush=True)
    print(f"[dist-probe] torch {torch.__version__}: {len(CASES) - failed} of {len(CASES)} cases ran")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
