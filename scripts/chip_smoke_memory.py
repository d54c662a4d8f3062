"""Device memory held across ``chip_smoke.py``'s phases, on the card:

    python3 scripts/chip_smoke_memory.py            # every phase up to [encdec]
    python3 scripts/chip_smoke_memory.py --alone    # [encdec] alone after the build

Prints ``torch.cuda.memory_allocated`` after each phase and after a
``gc.collect()`` there (what reference cycles were holding), and before
each of phase ``[encdec]``'s train steps; with ``--alone`` also after its
forward and decode parts, with the peak reset before each train step.
It stops after phase ``[encdec]``."""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def gb() -> float:
    return torch.cuda.memory_allocated() / 1e9


def report(tag: str) -> None:
    torch.cuda.synchronize()
    held = gb()
    gc.collect()
    print(f"[memory] {tag}: allocated {held:.2f} GB, after gc {gb():.2f}, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)


def after(name: str) -> None:
    """Report once ``chip_smoke.<name>`` returns."""
    fn = getattr(c, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        report(f"after {name}")
        return out

    setattr(c, name, wrapped)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--alone", action="store_true", help="run phase [encdec] alone")
    args = ap.parse_args()

    build_train_step = c.build_train_step

    def counted(*a, **k):
        step = build_train_step(*a, **k)

        def run(*xs):
            if args.alone:
                report("encdec train: before a step")
                torch.cuda.reset_peak_memory_stats()
            else:
                print(f"[memory] encdec step: allocated before {gb():.2f} GB", flush=True)
            return step(*xs)
        return run

    c.build_train_step = counted
    if args.alone:
        for name in ("phase_flash_forward", "encdec_decode"):
            after(name)
        c.phase_device()
        c.phase_build()
        report("start")
        c.phase_encdec()
        report("end")
        return
    for name in ("phase_kernels", "phase_bitmap", "phase_pud_host", "phase_gemv", "phase_serve",
                 "phase_granite_serve", "phase_moe_serve", "phase_vlm", "phase_encdec"):
        after(name)

    def stop():
        raise SystemExit(0)

    c.phase_small_vs_cpu = stop      # the first phase after [encdec]
    c.main()


if __name__ == "__main__":
    main()
