"""End-to-end training example of the port: synthetic corpus -> packed batches
-> AdamW with checkpoint/restart and failure recovery, through
``repro_torch``'s ``Trainer`` (the reference's ``examples/train_lm.py``).

Default is the smoke model; ``--model 100m`` trains a ~100M-param config
(chunked attention, full per-layer rematerialization, as the reference's).
Runs on the card unless ``--device cpu`` is given::

    PYTHONPATH=src python examples/torch_train_lm.py --steps 100 [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --model 100m --steps 20
    PYTHONPATH=src python examples/torch_train_lm.py --steps 100 --inject-failure 37
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.append(str(_SRC))

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def model_for(size: str) -> ModelConfig:
    if size == "smoke":
        return get_config("stablelm_1_6b").smoke()
    if size == "100m":
        return dataclasses.replace(
            get_config("stablelm_1_6b"),
            name="stablelm-100m",
            n_layers=10, d_model=640, n_heads=10, n_kv_heads=10,
            head_dim=64, d_ff=1792, vocab_size=32768, dtype="float32",
        )
    raise SystemExit(f"unknown --model {size}")


def main(argv=None, *, init_params=None) -> dict:
    """Parse ``argv``, train, print the summary line; returns the trainer's
    output.  ``init_params`` (a callable returning a param tree on the
    device) replaces the model's own seeded init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true",
                    help="raises: the compressed train step wants an error-feedback state "
                         "the training loop never passes (the reference's fault 1, where it "
                         "retries step 0 forever); the port's trainer gives up after one "
                         "recovery. The collective form, compressed_psum, is in "
                         "repro_torch.optim.compression")
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="raise at this step once, to demo recovery")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_for(args.model)
    model = LM(cfg, attn_impl="chunked", remat=None if args.model == "smoke" else "full")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_per_shard=args.batch)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=10, accum_steps=args.accum,
        grad_compression=args.grad_compression,
    )

    boom = {"armed": args.inject_failure is not None}

    def failure_hook(step):
        if boom["armed"] and step == args.inject_failure:
            boom["armed"] = False
            raise RuntimeError("injected failure (node loss simulation)")

    out = Trainer(
        model, data, ocfg, tcfg, device=args.device, init_params=init_params,
        failure_hook=failure_hook if args.inject_failure is not None else None,
    ).run()
    losses = [m["loss"] for _, m in out["history"]]
    print(
        f"\ndone: {len(losses)} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"recoveries={out['recoveries']}, stragglers={out['stragglers']}"
    )
    return out


if __name__ == "__main__":
    main()
