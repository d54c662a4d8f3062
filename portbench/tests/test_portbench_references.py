"""A configuration names the reference that runs it, and the published keys
that reference declares travel on the ``Arch`` to both sides: the existing
configuration loads as before, on ``model``; a stub reference named by a
configuration is what the serving check and the training path call; the
Granite multipliers are refused without their reference and, with it, by
the program, which has no field for them; and ``granite_moe.py``'s four
equations hold against the shared forward on folded weights."""
import dataclasses
import json
import math
import shutil
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import arch, cells, check, program, reference, traffic, train, weights
from portbench.reference import granite_moe
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

#: the core of each configuration as it loaded before a file could name its reference
CORE = {
    "stablelm_1_6b": arch.Arch(
        name="stablelm_1_6b", n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=5632, vocab_size=100352, norm="layernorm", norm_eps=1e-6,
        rope_theta=10000.0, tie_embeddings=False, dtype="bfloat16", init_std=0.02,
        n_experts=0, experts_per_tok=0, capacity_factor=1.25, max_positions=4096),
}

#: ibm-granite/granite-3.0-3b-a800m-base's config.json, the keys the harness reads
GRANITE = {
    "source": "https://huggingface.co/ibm-granite/granite-3.0-3b-a800m-base",
    "model_type": "granitemoe", "hidden_size": 1536, "intermediate_size": 512,
    "num_hidden_layers": 32, "num_attention_heads": 24, "num_key_value_heads": 8,
    "num_local_experts": 40, "num_experts_per_tok": 8, "vocab_size": 49155,
    "max_position_embeddings": 4096, "rope_theta": 10000, "rms_norm_eps": 1e-6,
    "initializer_range": 0.02, "tie_word_embeddings": True, "torch_dtype": "bfloat16",
    "attention_bias": False, "embedding_multiplier": 12.0, "attention_multiplier": 0.015625,
    "residual_multiplier": 0.22, "logits_scaling": 6.0, "hidden_act": "silu", "norm": "rmsnorm",
    "departures": {"rotary": "interleaved"},
}
MULTIPLIERS = ("embedding_multiplier", "attention_multiplier", "residual_multiplier",
               "logits_scaling")


def write_config(path: Path, **over) -> Path:
    path.write_text(json.dumps({**GRANITE, **over}))
    return path


def granite_smoke(tmp_path, **over) -> arch.Arch:
    """The Granite configuration on its reference at smoke size, float32."""
    a = arch.load(write_config(tmp_path / "granite.json", reference="granite_moe", **over))
    return dataclasses.replace(a.smoke(), dtype="float32")


def draw(a: arch.Arch, seed: int = 5):
    """The harness's weights for ``a``: the program's layout, from a copy
    that carries no key (the program refuses the multipliers)."""
    defs = program.model(dataclasses.replace(a, keys=())).param_defs()
    return weights.make(defs, std=a.init_std, dtype=torch.float32, vocab_size=a.vocab_size,
                        seed=seed, device="cpu")


def tokens(a: arch.Arch, n: int = 48, seed: int = 1):
    return torch.randint(0, a.vocab_size, (n,), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", sorted(CORE))
def test_existing_configuration_loads_as_before(name):
    a = arch.load(HERE / "configs" / f"{name}.json")
    assert a.reference == "model" and a.keys == ()
    assert dataclasses.replace(a, reference="model", keys=()) == CORE[name]
    assert a.smoke().reference == "model" and a.smoke().keys == ()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_a_configuration_carries_only_what_its_reference_runs(name):
    file = next(c["file"] for c in BENCH["configs"] if c["name"] == name)
    a = arch.load(ROOT / file)
    runs = reference.neutral_keys(a.reference, a.head_dim)
    assert set(dict(a.keys)) <= set(runs)
    assert a.smoke().keys == a.keys and a.smoke().reference == a.reference


#: a published key of the one table away from its neutral value
OFF = [("rotary", "halves"), ("partial_rotary_factor", 0.25),
       ("rope_scaling", {"type": "linear", "factor": 2.0}), ("sliding_window", 4096),
       ("use_qkv_bias", True), ("attention_bias", True), ("qk_layernorm", True),
       ("use_parallel_residual", True), ("hidden_act", "gelu"), ("mlp_bias", True)]


@pytest.mark.parametrize("ref", ["model", "granite_moe"])
@pytest.mark.parametrize("key,value", OFF, ids=[k for k, _ in OFF])
def test_a_forward_key_no_reference_runs_is_refused(tmp_path, ref, key, value):
    """Each key of ``arch.forward_keys`` away from its neutral value, under
    a reference that declares none of them, is refused, naming the key and
    the reference; at its neutral value it loads."""
    base = (json.loads((HERE / "configs" / "stablelm_1_6b.json").read_text())
            if ref == "model" else {**GRANITE, "reference": ref})
    off = {**base, "departures": {**base["departures"], key: value}}
    path = tmp_path / "off.json"
    path.write_text(json.dumps(off))
    with pytest.raises(ValueError, match=rf"{key} = .* reference '{ref}'"):
        arch.load(path)
    neutral = arch.forward_keys(64)[key]
    path.write_text(json.dumps({**base, "departures": {**base["departures"], key: neutral}}))
    assert key not in dict(arch.load(path).keys)


def test_a_file_that_states_no_rotary_is_refused(tmp_path):
    """A published config.json holds no ``rotary``: the file has to say how
    the model rotates, or a half-split model would pass as interleaved."""
    with pytest.raises(ValueError, match="states no \"rotary\""):
        arch.load(write_config(tmp_path / "granite.json", reference="granite_moe",
                               departures={}))


def test_granite_keys_travel_on_the_arch(tmp_path):
    a = arch.load(write_config(tmp_path / "granite.json", reference="granite_moe"))
    assert a.reference == "granite_moe"
    assert dict(a.keys) == {k: GRANITE[k] for k in MULTIPLIERS}
    assert hash(a) == hash(dataclasses.replace(a))
    s = a.smoke()
    assert s.keys == a.keys and s.reference == "granite_moe" and hash(s)
    assert granite_moe.multipliers(s) == {k: GRANITE[k] for k in MULTIPLIERS}


@pytest.mark.parametrize("key", MULTIPLIERS)
def test_granite_key_refused_without_its_reference(tmp_path, key):
    """A multiplier away from its neutral value, in a file that names no
    reference: ``model`` runs none of them."""
    neutral = granite_moe.neutral_keys(64)
    over = {k: neutral[k] for k in MULTIPLIERS if k != key}
    with pytest.raises(ValueError, match=rf"{key} = .* 'model'"):
        arch.load(write_config(tmp_path / "granite.json", **over))


@pytest.mark.parametrize("key", MULTIPLIERS)
def test_granite_key_refused_by_the_program(tmp_path, key):
    """With its reference the file loads, and ``port_config`` refuses the
    key: the program's ``ModelConfig`` has no field of its name."""
    neutral = granite_moe.neutral_keys(64)
    over = {k: neutral[k] for k in MULTIPLIERS if k != key}
    a = arch.load(write_config(tmp_path / "granite.json", reference="granite_moe", **over))
    assert dict(a.keys)[key] == GRANITE[key]
    with pytest.raises(ValueError, match=rf"{key} = .* is not run by the program"):
        program.port_config(a)


def test_neutral_granite_keys_reach_the_program(tmp_path):
    a = arch.load(write_config(tmp_path / "granite.json", reference="granite_moe",
                               **granite_moe.neutral_keys(64)))
    assert len(a.keys) == 4
    assert program.port_config(a) == program.port_config(dataclasses.replace(a, keys=()))


def test_unknown_reference_is_refused(tmp_path):
    with pytest.raises(ValueError, match="no reference/nothing.py"):
        arch.load(write_config(tmp_path / "granite.json", reference="nothing"))


def fold(w, a: arch.Arch):
    """Weights on which the shared forward computes what ``granite_moe``
    computes on ``w``, and each leaf's factor."""
    m = granite_moe.multipliers(a)
    em, ls, r = m["embedding_multiplier"], m["logits_scaling"], m["residual_multiplier"]
    factor = {"embed.tok": em, "final_ln.scale": 1 / (em * ls),
              "layers.attn.wq": m["attention_multiplier"] * math.sqrt(a.head_dim),
              "layers.attn.wo": r, "layers.moe.wo": r}
    folded = {n: t * factor.get(n, 1.0) for n, t in ref_train.leaves(w)}
    return ref_train._rebuild(w, folded), factor


def test_fold_identity_logits(tmp_path):
    a = granite_smoke(tmp_path)
    w = draw(a)
    w_fold, _ = fold(w, a)
    toks = tokens(a).tolist()
    got = granite_moe.logits(w, a, toks, range(len(toks)))
    want = ref_model.logits(w_fold, a, toks, range(len(toks)))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # and the multipliers do change the logits
    plain = ref_model.logits(w, a, toks, range(len(toks)))
    assert (got - plain).abs().max() > 1e-2 * plain.abs().max()


def test_fold_identity_training(tmp_path):
    """The loss and each leaf's first gradient: the shared forward's on the
    folded weights, times the leaf's factor (no clipping)."""
    a = granite_smoke(tmp_path)
    w = draw(a)
    w_fold, factor = fold(w, a)
    job = traffic.load(HERE / "traffic" / "train_2k.json", smoke=True)
    opt = {**job["optimizer"], "clip_norm": 1e30}
    batches = [train.batch(job, 9, 0, a.vocab_size, "cpu")]
    got = ref_train.steps(w, a, batches, opt)
    want = ref_train.steps(w_fold, dataclasses.replace(a, reference="model", keys=()),
                           batches, opt)
    assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5 * abs(want["loss"][0])
    for n, g in got["grad"].items():
        expect = want["grad"][n] * factor.get(n, 1.0)
        assert abs(g - expect) <= 1e-5 * expect, n


@pytest.mark.parametrize("precision", ["f32", "fp8"])
def test_neutral_granite_is_the_shared_forward(tmp_path, precision):
    """With its four keys neutral, ``granite_moe`` is ``model`` bit for bit,
    in the logits and in the training path."""
    a = granite_smoke(tmp_path, **granite_moe.neutral_keys(64))
    a = dataclasses.replace(a, keys=tuple((k, granite_moe.neutral_keys(a.head_dim)[k])
                                          for k, _ in a.keys))
    shared = dataclasses.replace(a, reference="model", keys=())
    w = draw(a)
    toks = tokens(a).tolist()
    assert torch.equal(granite_moe.logits(w, a, toks, range(10, 48), precision=precision),
                       ref_model.logits(w, shared, toks, range(10, 48), precision=precision))
    job = traffic.load(HERE / "traffic" / "train_2k.json", smoke=True)
    batches = [train.batch(job, 3, i, a.vocab_size, "cpu") for i in range(2)]
    assert (ref_train.steps(w, a, batches, job["optimizer"], precision=precision)
            == ref_train.steps(w, shared, batches, job["optimizer"], precision=precision))


STUB = '''"""A stub reference: the shared forward, noting each call."""
from portbench.reference import model

CALLS = []


def logits(*args, **kwargs):
    CALLS.append("logits")
    return model.logits(*args, **kwargs)


def _block(*args, **kwargs):
    CALLS.append("block")
    return model.block(*args, **kwargs)


FORWARD = model.Forward(embed=model.embed, block=_block, final=model.final)


def neutral_keys(head_dim):
    return {"rope_scaling": None, "stub_factor": 1.0}
'''

#: more references of the copy: one whose neutral disagrees with the
#: harness's table, one that fails to import
ADDED = {
    "serve_only": "from portbench.reference.model import logits  # noqa: F401\n",
    "clash": "def neutral_keys(head_dim):\n    return {'attention_multiplier': 1.0}\n",
    "broken": "raise ImportError('a broken reference')\n",
}


@pytest.fixture
def stub_copy(tmp_path):
    """A copy of the benchmark with two configurations that name references
    of their own: ``stubbed`` (``reference/stub.py``, serving and training)
    and ``served_only`` (``reference/serve_only.py``, no ``FORWARD``), each
    with a serving and a training cell."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "portbench"
    (here / "reference" / "stub.py").write_text(STUB)
    for name, text in ADDED.items():
        (here / "reference" / f"{name}.py").write_text(text)
    bench = json.loads(json.dumps(BENCH))
    base = json.loads((here / "configs" / "stablelm_1_6b.json").read_text())
    for name, ref in (("stubbed", "stub"), ("served_only", "serve_only")):
        (here / "configs" / f"{name}.json").write_text(json.dumps({**base, "reference": ref}))
        bench["configs"].append({"name": name, "source": "https://example.org",
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "a test"})
        for mix in ("decode_32", "train_2k"):
            cell = f"{name}.{mix}"
            bench["workloads"].append({"name": cell, "config": name, "traffic": mix,
                                       "chips": 1, "why": "a test"})
            shutil.copy(here / "limits" / f"stablelm_1_6b.{mix}.json",
                        here / "limits" / f"{cell}.json")
            for m in bench["end_to_end"] + bench["per_layer"]:
                if f"stablelm_1_6b.{mix}" in m.get("workloads", []):
                    m["workloads"].append(cell)
    yield tmp_path, bench
    for name in ["stub", *ADDED]:
        sys.modules.pop(f"{reference.__name__}.{name}", None)


def test_a_configuration_brings_its_own_reference(stub_copy):
    """``check.compare`` (the program's tokens and the control) and the
    training path call the reference the configuration names."""
    root, bench = stub_copy
    c = cells.resolve(bench, "stubbed.decode_32", root=root)
    a = dataclasses.replace(arch.load(c.config_file, root).smoke(), dtype="float32")
    assert a.reference == "stub" and a.keys == ()
    calls = reference.module("stub").CALLS
    w = draw(a)
    toks = tokens(a, 30).tolist()
    rec = types.SimpleNamespace(prompt=toks[:20], max_new=10,
                                req=types.SimpleNamespace(out=toks[20:]))
    got = check.compare(w, a, [rec], control=True)
    assert calls == ["logits", "logits"]
    shared = check.compare(w, dataclasses.replace(a, reference="model"), [rec], control=True)
    assert (got["logit_gap"], got["control_gap"]) == (shared["logit_gap"], shared["control_gap"])

    cells.resolve(bench, "stubbed.train_2k", root=root)
    job = traffic.load(HERE / "traffic" / "train_2k.json", smoke=True)
    ref_train.steps(w, a, [train.batch(job, 4, 0, a.vocab_size, "cpu")], job["optimizer"])
    assert calls.count("block") >= a.n_layers * job["batch"]


def test_a_reference_without_a_training_path_is_refused(stub_copy):
    """A training cell over a configuration whose reference has no
    ``FORWARD`` is refused when the cell resolves, and the training path
    never falls back to the shared reference."""
    root, bench = stub_copy
    c = cells.resolve(bench, "served_only.decode_32", root=root)
    with pytest.raises(ValueError, match="serve_only.*no training path"):
        cells.resolve(bench, "served_only.train_2k", root=root)
    a = dataclasses.replace(arch.load(c.config_file, root).smoke(), dtype="float32")
    with pytest.raises(ValueError, match="no training path"):
        ref_train.steps(draw(a), a, [], {})


def with_reference(root: Path, ref: str, **over) -> Path:
    """A copy of the existing configuration, under ``root``, that names ``ref``."""
    base = json.loads((HERE / "configs" / "stablelm_1_6b.json").read_text())
    path = root / "portbench" / "configs" / f"{ref}_{len(over)}.json"
    path.write_text(json.dumps({**base, "reference": ref, **over}))
    return path


def test_only_the_named_reference_is_imported(stub_copy):
    """A reference that fails to import breaks only the configurations that
    name it; the others, and their cells, load as before."""
    root, bench = stub_copy
    assert f"{reference.__name__}.broken" not in sys.modules
    cells.resolve(bench, "stubbed.train_2k", root=root)
    cells.resolve(bench, "stablelm_1_6b.decode_32", root=root)
    assert f"{reference.__name__}.broken" not in sys.modules
    with pytest.raises(ImportError, match="a broken reference"):
        arch.load(with_reference(root, "broken"), root)
    assert f"{reference.__name__}.broken" not in sys.modules


def test_a_reference_is_found_under_the_root_it_is_given(stub_copy, tmp_path_factory):
    """A reference only the copy holds is found under the copy's root, and
    not under another."""
    root, _ = stub_copy
    path = with_reference(root, "stub", stub_factor=2.0)
    other = tmp_path_factory.mktemp("other")
    with pytest.raises(ValueError, match="no reference/stub.py"):
        reference.module("stub", other)
    a = arch.load(path, root)
    assert dict(a.keys) == {"stub_factor": 2.0}
    stub = root / "portbench" / "reference" / "stub.py"
    assert Path(reference.module("stub").__file__).resolve() == stub.resolve()


def test_a_reference_that_disagrees_with_the_table_is_refused(stub_copy):
    """``reference/clash.py`` declares ``attention_multiplier`` neutral at
    1.0, where the harness's one table has 1 / sqrt(head_dim)."""
    root, _ = stub_copy
    with pytest.raises(ValueError, match=r"clash.py declares attention_multiplier neutral at 1.0"):
        arch.load(with_reference(root, "clash"), root)


def test_a_carried_key_holds_a_plain_value(stub_copy):
    """``stub`` runs ``rope_scaling``; a group there is refused, since a
    carried key travels as a number, a string or a truth value."""
    root, _ = stub_copy
    with pytest.raises(ValueError, match="rope_scaling = .* a carried key holds a number"):
        arch.load(with_reference(root, "stub", rope_scaling={"type": "linear", "factor": 2.0}),
                  root)
