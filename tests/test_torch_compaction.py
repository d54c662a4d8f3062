"""The port's robustness layer against the reference: compaction plans and
reports, invariant audits, journal replay and digests, ``PagedKVPool.compact``
(K/V moved bit-exactly), and the serving engine's watermark maintenance.

The same seeded scripts run through ``repro`` and ``repro_torch`` on the
CPU; host state, digests and prices are held equal exactly, K/V bytes
bit-exactly, and generated ids equal.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.allocators as ref_allocators  # noqa: E402
import repro.core.arena as ref_arena  # noqa: E402
import repro.core.controller as ref_controller  # noqa: E402
import repro.core.dram as ref_dram  # noqa: E402
import repro.core.kv_pool as ref_kv_pool  # noqa: E402
import repro.core.puma as ref_puma  # noqa: E402
import repro.robustness as ref_rob  # noqa: E402
import repro.robustness.compaction as ref_compaction  # noqa: E402
import repro.robustness.journal as ref_journal  # noqa: E402
import repro_torch.core.allocators as port_allocators  # noqa: E402
import repro_torch.core.arena as port_arena  # noqa: E402
import repro_torch.core.controller as port_controller  # noqa: E402
import repro_torch.core.dram as port_dram  # noqa: E402
import repro_torch.core.kv_pool as port_kv_pool  # noqa: E402
import repro_torch.core.puma as port_puma  # noqa: E402
import repro_torch.robustness as port_rob  # noqa: E402
import repro_torch.robustness.compaction as port_compaction  # noqa: E402
import repro_torch.robustness.journal as port_journal  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro.serve.engine import MaintenanceConfig as RefMaintenance  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import MaintenanceConfig, Request, ServeEngine  # noqa: E402

PKGS = {
    "ref": dict(dram=ref_dram, allocators=ref_allocators, puma=ref_puma, arena=ref_arena,
                controller=ref_controller, compaction=ref_compaction, journal=ref_journal,
                rob=ref_rob, kv_pool=ref_kv_pool),
    "port": dict(dram=port_dram, allocators=port_allocators, puma=port_puma, arena=port_arena,
                 controller=port_controller, compaction=port_compaction, journal=port_journal,
                 rob=port_rob, kv_pool=port_kv_pool),
}


def _reports(reports):
    return [None if r is None else r.as_dict() for r in reports]


def _allocator_script(pkg, cycles=600, seed=42):
    """Churn a journaled PUMA pool, compacting every 200 cycles (with the
    bytes moved on a numpy "physical memory" and priced on controllers)."""
    m = PKGS[pkg]
    amap = m["dram"].AddressMap(
        m["dram"].DramGeometry(channels=4, subarrays_per_bank=16, rows_per_subarray=32))
    region = amap.region_bytes
    j = m["journal"].Journal()
    pa = m["puma"].PumaAllocator(m["allocators"].PhysicalMemory(amap, seed=7, n_huge_pages=4),
                                 journal=j)
    pa.pim_preallocate(4)
    total = pa.free_regions()
    phys = np.random.default_rng(3).integers(0, 256, amap.total_bytes, dtype=np.uint8)
    ctl = m["controller"].DramController(amap)
    rng = random.Random(seed)
    live, reports, plans = [], [], []
    for cycle in range(cycles):
        if live and (pa.free_regions() < total // 8 or rng.random() < 0.45):
            pa.pim_free(live.pop(rng.randrange(len(live))))
        else:
            a = pa.pim_alloc(rng.randint(region // 2, 4 * region))
            if a is not None:
                live.append(a)
        if cycle % 200 == 199:
            plan = m["compaction"].plan_allocator_compaction(pa)
            plans.append([(mv.owner, mv.index, mv.src, mv.dst, mv.rowclone) for mv in plan.moves])
            reports.append(m["compaction"].compact_allocator(pa, plan, phys=phys,
                                                             controller=ctl))
    m["rob"].check_allocator(pa).assert_ok()
    return dict(pa=pa, journal=j, phys=phys, plans=plans, reports=_reports(reports),
                digest=m["journal"].allocator_digest(pa), occupancy=ctl.occupancy_report(),
                replayed=m["journal"].allocator_digest(m["journal"].replay_allocator(
                    j, m["allocators"].PhysicalMemory(amap, seed=7, n_huge_pages=4))))


def test_allocator_compaction_and_journal_match_reference():
    ref, port = _allocator_script("ref"), _allocator_script("port")
    assert any(port["plans"])
    for key in ("plans", "reports", "digest", "occupancy", "replayed"):
        assert port[key] == ref[key], key
    assert port["replayed"] == port["digest"]
    assert np.array_equal(port["phys"], ref["phys"])
    assert port["journal"].to_json() == ref["journal"].to_json()


def _pool_script(pkg, seed=9):
    m = PKGS[pkg]
    j = m["journal"].Journal()
    pool = m["arena"].TilePool(8, 32, "puma", journal=j)
    rng = random.Random(seed)
    live = []
    for _ in range(800):
        roll = rng.random()
        if live and roll < 0.40:
            pool.free(live.pop(rng.randrange(len(live))))
        elif live and roll < 0.55:
            pool.extend(rng.choice(live), 1)
        else:
            h = pool.alloc(rng.randint(1, 8))
            if h is not None:
                live.append(h)
    plan = m["compaction"].plan_pool_compaction(pool)
    report = m["compaction"].compact_pool(pool, plan, tile_bytes=4096)
    m["rob"].check_tile_pool(pool).assert_ok()
    replayed = m["journal"].replay_pool(j, n_arenas=8, tiles_per_arena=32, policy="puma")
    return dict(moves=[(mv.owner, mv.index, mv.src, mv.dst, mv.rowclone) for mv in plan.moves],
                report=report.as_dict(), digest=m["journal"].pool_digest(pool),
                replayed=m["journal"].pool_digest(replayed))


def test_tile_pool_compaction_and_journal_match_reference():
    ref, port = _pool_script("ref"), _pool_script("port")
    assert port["moves"]
    assert port == ref
    assert port["replayed"] == port["digest"]


def _kv_cfg(pkg, n_layers=2):
    return PKGS[pkg]["kv_pool"].KVPoolConfig(
        num_blocks=64, block_size=4, kv_heads=2, head_dim=8, n_layers=n_layers,
        max_seqs=16, max_blocks_per_seq=16, blocks_per_arena=16, policy="puma",
        dtype="float32")


def test_kv_compact_moves_data_bit_exactly_as_reference():
    """tests/test_compaction.py's KV compaction script on both pools: the
    same moves, equal K/V after the pass, equal digests."""
    cfg_r, cfg_p = _kv_cfg("ref"), _kv_cfg("port")
    j_r, j_p = ref_journal.Journal(), port_journal.Journal()
    kv_r = ref_kv_pool.PagedKVPool(cfg_r, journal=j_r)
    kv_p = port_kv_pool.PagedKVPool(cfg_p, journal=j_p, device="cpu")
    shape = tuple(kv_p.k.shape)
    init = np.random.default_rng(0).standard_normal((2,) + shape).astype(np.float32)
    kv_r.k, kv_r.v = jnp.asarray(init[0]), jnp.asarray(init[1])
    kv_p.k.copy_(torch.from_numpy(init[0]))
    kv_p.v.copy_(torch.from_numpy(init[1]))

    slots = {}
    for name, kv in (("ref", kv_r), ("port", kv_p)):
        rng = np.random.default_rng(11)
        s = [kv.admit(int(rng.integers(3, 13))) for _ in range(10)]
        for x in s[::2]:
            kv.release(x)
        s = s[1::2] + [kv.admit(int(rng.integers(8, 20))) for _ in range(3)]
        slots[name] = [x for x in s if x is not None]
    assert slots["port"] == slots["ref"]
    before = {s: list(kv_p._seqs[s][0].tiles) for s in slots["port"]}

    rep_r = kv_r.compact(max_moves=64)
    launches = kernels.launches["block_copy"]
    rep_p = kv_p.compact(max_moves=64)
    assert kernels.launches["block_copy"] == launches      # CPU: the plain path
    assert rep_p is not None and rep_p.executed > 0
    assert rep_p.as_dict() == rep_r.as_dict()
    port_rob.check_kv_pool(kv_p).assert_ok()
    np.testing.assert_array_equal(kv_p.k.numpy(), np.asarray(kv_r.k))
    np.testing.assert_array_equal(kv_p.v.numpy(), np.asarray(kv_r.v))
    np.testing.assert_array_equal(kv_p.block_table(), kv_r.block_table())
    assert port_journal.kv_pool_digest(kv_p) == ref_journal.kv_pool_digest(kv_r)
    assert j_p.to_json() == j_r.to_json()
    # each live block's pages followed it: data at the new block == old block's
    moved = False
    for s in slots["port"]:
        old, new = before[s], kv_p._seqs[s][0].tiles
        moved |= old != new
        np.testing.assert_array_equal(kv_p.k[:, new].numpy(), init[0][:, old])
        np.testing.assert_array_equal(kv_p.v[:, new].numpy(), init[1][:, old])
    assert moved


def _kv_journal_script(kv):
    rng = random.Random(13)
    remaining = {}
    for _ in range(500):
        if (not remaining) or (rng.random() < 0.15 and kv._free_slots):
            slot = kv.admit(rng.randint(2, 30))
            if slot is not None:
                remaining[slot] = rng.randint(1, 40)
        else:
            slot = rng.choice(sorted(remaining))
            if rng.random() < 0.05:
                forked = kv.fork(slot)
                if forked is not None:
                    remaining[forked] = remaining[slot]
            if kv.append_token(slot):
                remaining[slot] -= 1
            else:
                remaining[slot] = 0
            if remaining[slot] <= 0:
                del remaining[slot]
                kv.release(slot)
    return kv.compact()


def test_kv_pool_journal_replay_matches_reference():
    cfg_r, cfg_p = _kv_cfg("ref", n_layers=1), _kv_cfg("port", n_layers=1)
    j_r, j_p = ref_journal.Journal(), port_journal.Journal()
    kv_r = ref_kv_pool.PagedKVPool(cfg_r, journal=j_r)
    kv_p = port_kv_pool.PagedKVPool(cfg_p, journal=j_p, device="cpu")
    rep_r, rep_p = _kv_journal_script(kv_r), _kv_journal_script(kv_p)
    assert _reports([rep_p]) == _reports([rep_r])
    assert j_p.to_json() == j_r.to_json()
    replayed = port_journal.replay_kv_pool(j_p, cfg_p, device="cpu")
    assert replayed.k.device.type == "cpu"
    digest = port_journal.kv_pool_digest(kv_p)
    assert digest == ref_journal.kv_pool_digest(kv_r)
    assert port_journal.kv_pool_digest(replayed) == digest


def test_robustness_lazy_attributes_match_reference():
    assert sorted(port_rob.__all__) == sorted(ref_rob.__all__)
    for name in ref_rob.__all__:
        assert getattr(port_rob, name).__name__ == getattr(ref_rob, name).__name__


# -- the engine's watermark maintenance ----------------------------------------

def test_engine_maintenance_matches_reference():
    """tests/test_compaction.py's maintenance scenario in both engines: same
    ids, passes, migrated blocks and maintenance_ns; output unchanged."""
    ref_cfg = ref_get_config("stablelm_1_6b").smoke()
    ref = RefLM(ref_cfg, attn_impl="naive", remat=None)
    ref_params = ref.init(jax.random.key(0))
    model = LM(get_config("stablelm_1_6b").smoke())
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    cfg = model.cfg
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, 9))) for _ in range(4)]
    marks = dict(free_low=0.9, frag_high=0.05, contig_low=0.999, max_moves=64, every=2)

    def pool_cfg(pkg):
        return PKGS[pkg]["kv_pool"].KVPoolConfig(
            num_blocks=64, block_size=8, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            n_layers=cfg.n_layers, max_seqs=8, max_blocks_per_seq=16,
            blocks_per_arena=16, policy="puma", dtype="float32")

    def drive(pkg, maint):
        if pkg == "ref":
            eng = RefEngine(ref, ref_params, pool_cfg("ref"), use_kernel=False,
                            maintenance=RefMaintenance(**marks) if maint else None)
            req = RefRequest
        else:
            eng = ServeEngine(model, params, pool_cfg("port"), device="cpu",
                              maintenance=MaintenanceConfig(**marks) if maint else None)
            req = Request
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=list(p), max_new=6))
        out = {r.rid: r.out for r in eng.run()}
        m = eng.metrics()
        return out, {k: m[k] for k in ("compaction_passes", "blocks_migrated",
                                       "maintenance_ns", "clock", "steps")}

    base_ref, _ = drive("ref", False)
    base_port, _ = drive("port", False)
    out_ref, m_ref = drive("ref", True)
    out_port, m_port = drive("port", True)
    assert m_port["compaction_passes"] > 0 and m_port["blocks_migrated"] > 0
    assert m_port["maintenance_ns"] > 0
    assert m_port == m_ref
    assert out_port == out_ref == base_ref == base_port
