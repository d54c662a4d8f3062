"""The reference against the program at a smoke size on the CPU, both in
float32 from the harness's weights: a mistake in reading the weights, the
rotary or the routing shows here."""
import dataclasses
from pathlib import Path

import pytest
import torch

from portbench import arch, program, weights
from portbench.reference import model as ref_model

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def dense():
    return dataclasses.replace(arch.load(CONFIGS / "stablelm_1_6b.json").smoke(),
                               dtype="float32")


def moe():
    """A grouped-query MoE model at smoke size: 8 experts, top 2, tied
    embeddings, an odd vocabulary (padded by the program), no drops."""
    return arch.Arch(name="moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=32, vocab_size=500, norm="rmsnorm", norm_eps=1e-6,
                     rope_theta=1e4, tie_embeddings=True, dtype="float32", init_std=0.11,
                     n_experts=8, experts_per_tok=2, capacity_factor=4.0)


def build(a, seed=3):
    model = program.model(a)
    w = weights.make(model.param_defs(), std=a.init_std, dtype=torch.float32,
                     vocab_size=a.vocab_size, seed=seed, device="cpu")
    return model, w


@pytest.mark.parametrize("make", [dense, moe], ids=["dense", "moe"])
def test_prefill_logits_match(make):
    a = make()
    model, w = build(a)
    toks = torch.randint(0, a.vocab_size, (1, 40), generator=torch.Generator().manual_seed(1))
    got = model.prefill_logits(w, {"tokens": toks, "positions": torch.arange(40)[None]})
    want = ref_model.logits(w, a, toks[0].tolist(), [39])
    assert torch.allclose(got[:, :a.vocab_size], want, atol=1e-4 * want.abs().max().item())
    # the padded ids carry no logit
    assert got.shape[1] == 2048 and torch.all(got[:, a.vocab_size:] == 0)


@pytest.mark.parametrize("make", [dense, moe], ids=["dense", "moe"])
def test_served_tokens_are_the_references_best(make):
    """Prefill, then decode through the paged pool: each served token is the
    reference's best at its position (gaps at rounding level)."""
    program.import_port()
    from repro_torch.core.kv_pool import KVPoolConfig
    from repro_torch.serve.engine import Request, ServeEngine

    a = make()
    model, w = build(a)
    eng = ServeEngine(model, w, KVPoolConfig(
        num_blocks=64, block_size=4, kv_heads=a.n_kv_heads, head_dim=a.head_dim,
        n_layers=a.n_layers, max_seqs=3, max_blocks_per_seq=16, blocks_per_arena=16,
        dtype="float32"), device="cpu", jit=False)
    g = torch.Generator().manual_seed(2)
    reqs = [Request(rid=i, prompt=torch.randint(0, a.vocab_size, (n,), generator=g).tolist(),
                    max_new=m) for i, (n, m) in enumerate([(9, 6), (23, 8), (31, 5)])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert len(r.out) == r.max_new
        toks = r.prompt + r.out[:-1]
        ref = ref_model.logits(w, a, toks, range(len(r.prompt) - 1, len(toks)))
        assert max(ref_model.served_gaps(ref, r.out)) <= 1e-4 * ref.abs().max().item()


def test_control_rounds_through_float8():
    t = torch.tensor([448.0, 1.0, 0.3, -18.0])
    r = ref_model.round_fp8(t)
    assert r[0] == 448.0 and r[1] == 1.0 and r[3] == -18.0
    assert r[2] != 0.3 and abs(r[2] - 0.3) <= 0.3 / 16


def test_train_steps_match():
    """The program's first train steps (remat, chunked attention, AdamW in
    place) against the reference's, both float32: losses, first gradients
    and changes by leaf."""
    from portbench import check, traffic, train
    from portbench.reference import train as ref_train

    a = dense()
    job_cfg = traffic.load(Path(__file__).resolve().parents[1] / "traffic" / "train_2k.json",
                           smoke=True)
    model = program.model(a, attn_impl=job_cfg["attn_impl"], remat=job_cfg["remat"])
    w = weights.make(model.param_defs(), std=a.init_std, dtype=torch.float32,
                     vocab_size=a.vocab_size, seed=11, device="cpu")
    job = train.Job(model, w, job_cfg, 11, arch=a, device="cpu", cuda=False)
    job.first_steps()
    w0 = weights.make(model.param_defs(), std=a.init_std, dtype=torch.float32,
                      vocab_size=a.vocab_size, seed=11, device="cpu")
    batches = [train.batch(job_cfg, 11, i, a.vocab_size, "cpu")
               for i in range(job_cfg["check_steps"])]
    gaps = check.train_gaps(job.program, ref_train.steps(w0, a, batches, job_cfg["optimizer"]))
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3, gaps
