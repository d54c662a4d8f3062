"""``correct`` has to come out false for the control and for each fault a
cell can have.

On the CPU, at the smoke size (``run.py --smoke``, bf16 program, the same
code path as a run with the look for a card skipped): the program's
readings are under the smoke limits and the float8 control's over one of
them; in a serving cell a token altered where the decode step produces it,
and a decode step that leaves the K/V pool as it found it, in the training
cell a step that returns its state unchanged and a step that takes half of
the batch and the mean over it, each turn ``correct`` false.  On the card
(marker ``cuda``), each cell at its own size on three seeds: the control
fails a limit of the cell and the program passes them all; in the
training cell each fault as well.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KIND = {w["name"]: json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
                              .read_text())["kind"] for w in BENCH["workloads"]}
SERVING = [c for c in CELLS if KIND[c] != "train"]
TRAINING = [c for c in CELLS if KIND[c] == "train"]

# planted in the program before the run; the harness itself is untouched
FAULTS = {
    # every decoded token replaced by the next id where the step produces it
    "token_altered": (
        "from repro_torch.serve import engine as E\n"
        "step = E.paged_decode_step_jit\n"
        "def altered(*a, **k):\n"
        "    logits, nk, nv = step(*a, **k)\n"
        "    shifted = torch.roll(logits, 1, dims=-1)\n"
        "    return shifted, nk, nv\n"
        "E.paged_decode_step_jit = altered\n"),
    # the decode step's K/V never reach the pool: its state is left unchanged
    "state_unchanged": (
        "from repro_torch.core.kv_pool import PagedKVPool\n"
        "PagedKVPool.write_token_kv = lambda self, *a: None\n"),
}
TRAIN_FAULTS = {
    # AdamW leaves the params and its moments as they were
    "state_unchanged": (
        "from repro_torch.optim import adamw\n"
        "adamw.apply_updates = lambda p, g, s, cfg, donate=False: (\n"
        "    p, s, {'grad_norm': adamw.global_norm(g), 'lr': adamw.schedule(cfg, s.step + 1)})\n"),
    # the step sees the first half of the batch's rows, its loss their mean
    "half_batch": (
        "from repro_torch.train import step as S\n"
        "build = S.build_train_step\n"
        "def halved(*a, **k):\n"
        "    f = build(*a, **k)\n"
        "    def g(params, opt, batch, *r):\n"
        "        return f(params, opt, {n: t[: t.shape[0] // 2] for n, t in batch.items()}, *r)\n"
        "    return g\n"
        "S.build_train_step = halved\n"),
}


def run(cell, seed, *, smoke=True, control=0, fault=None, seconds=1, timeout=300):
    faults = TRAIN_FAULTS if KIND[cell] == "train" else FAULTS
    args = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", "0", "--control", str(control)] + (["--smoke"] if smoke else [])
    code = (
        "import sys, importlib.util, torch\n"
        # few threads a run, so that runs beside other tests' workers keep their pace
        "torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import program\n"
        "program.import_port()\n"
        + (faults[fault] if fault else "")
        + f"spec = importlib.util.spec_from_file_location('pb_run', {str(ROOT / 'portbench' / 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        f"sys.exit(run.main({args!r}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def control_fails(out) -> bool:
    """The control's readings fail at least one of the run's limits."""
    checks, control = out["checks"], out["control"]
    if "control_gap" in control:
        return control["control_gap"] > checks["logit_gap"]["limit"]
    return any(v > checks[k]["limit"] for k, v in control["control"].items() if k in checks)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_smoke_size(cell):
    out = run(cell, 2 ** 31 + 77, control=1)
    assert out["correct"], out["checks"]
    assert control_fails(out), out


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", SERVING)
def test_serving_fault_turns_correct_false(cell, fault):
    out = run(cell, 4242, fault=fault)
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("cell", TRAINING)
def test_training_fault_turns_correct_false(cell, fault):
    out = run(cell, 4242, fault=fault)
    assert out["correct"] is False, out["checks"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size on the card")


SEEDS = (2 ** 31 + 3, 2 ** 32 + 11, 123457)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell):
    seconds = 1 if KIND[cell] == "train" else BENCH["run_seconds"]
    for seed in SEEDS:
        out = run(cell, seed, smoke=False, control=1, seconds=seconds, timeout=900)
        print(cell, seed, json.dumps(out["control"]))
        assert out["correct"] and control_fails(out), out


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("cell", TRAINING)
def test_training_fault_at_cell_size(card, cell, fault):
    for seed in SEEDS:
        out = run(cell, seed, smoke=False, fault=fault, seconds=1, timeout=900)
        print(cell, fault, seed, json.dumps({k: c["value"] for k, c in out["checks"].items()}))
        assert out["correct"] is False, out["checks"]
