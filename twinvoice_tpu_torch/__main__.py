"""Command-line entry points: the port of ``twinvoice_tpu/__main__.py``.

    python -m twinvoice_tpu_torch build-dataset [--json-dir J --images-dir I ...]
    python -m twinvoice_tpu_torch train [--epochs N --batch-size B ... --device D]
    python -m twinvoice_tpu_torch train-ocr --out W.npz [--pool LINES.npz]
        [--steps N --batch-size B --device D]
    python -m twinvoice_tpu_torch app

``build-dataset`` and ``train`` take the JAX CLI's arguments and defaults;
``train`` runs ``train.trainer.fit``. ``train-ocr`` trains the recognizer
(``ocr/torchocr/train.py``) as the JAX CLI's does, from a fresh batch of
its own renders each step (``data.make_lines``), or, given ``--pool``, from
an npz of lines (``read_line_npz``'s keys). ``--out`` names the weights
file, so that the bundled weights are never overwritten. As JAX's, it
refuses a run of at most 100 steps (the learning rate's warmup). ``--device`` picks the device of ``train`` and
``train-ocr``; the default is the card. ``app`` launches the Streamlit UI
(``app/main.py``) through ``python -m streamlit run``, as the JAX CLI's
does.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_build_dataset(args):
    from twinvoice_tpu_torch.data.labelme import build_dataset_from_labelme

    done, missing = build_dataset_from_labelme(
        json_dir=args.json_dir,
        images_dir=args.images_dir,
        out_img_dir=args.out_images,
        out_mask_dir=args.out_masks,
        train_size=(args.size, args.size),
    )
    print(f"built {len(done)} samples; {len(missing)} missing images")


def _cmd_train(args):
    from twinvoice_tpu_torch.config import Config, TrainConfig, UNetConfig
    from twinvoice_tpu_torch.data import dataset
    from twinvoice_tpu_torch.train import trainer

    cfg = Config(
        model=UNetConfig(),
        train=TrainConfig(
            batch_size=args.batch_size,
            epochs=args.epochs,
            lr=args.lr,
            val_fraction=args.val_fraction,
            checkpoint_dir=args.checkpoint_dir,
        ),
    )
    ds = dataset.load_invoice_dataset(args.images, args.masks)
    if len(ds) == 0:
        sys.exit(f"no samples found under {args.images} / {args.masks}")
    print(f"training on {len(ds)} samples")
    trainer.fit(ds, cfg, resume_dir=args.resume or None, device=args.device)


def _cmd_train_ocr(args):
    from twinvoice_tpu_torch.ocr.torchocr import train

    if args.pool:
        train.train_from_npz(args.pool, args.out, steps=args.steps, batch_size=args.batch_size,
                             device=args.device)
    else:  # JAX's train-ocr: a fresh batch of its own renders each step
        train.train(args.out, steps=args.steps, batch_size=args.batch_size, device=args.device)


def _cmd_app(_args):
    import subprocess

    subprocess.run(
        [sys.executable, "-m", "streamlit", "run",
         __file__.replace("__main__.py", "app/main.py")],
        check=True,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="twinvoice_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-dataset", help="labelme json+images → training pairs")
    b.add_argument("--json-dir", default="json")
    b.add_argument("--images-dir", default="images")
    b.add_argument("--out-images", default="fixed_images")
    b.add_argument("--out-masks", default="fixed_masks")
    b.add_argument("--size", type=int, default=512)
    b.set_defaults(fn=_cmd_build_dataset)

    t = sub.add_parser("train", help="train the U-Net segmenter")
    t.add_argument("--images", default="fixed_images")
    t.add_argument("--masks", default="fixed_masks")
    t.add_argument("--epochs", type=int, default=50)
    t.add_argument("--batch-size", type=int, default=4)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--val-fraction", type=float, default=0.0)
    t.add_argument("--checkpoint-dir", default="checkpoints")
    t.add_argument("--resume", default="")
    t.add_argument("--device", default=None, help="torch device (default: the card)")
    t.set_defaults(fn=_cmd_train)

    o = sub.add_parser("train-ocr", help="train the CTC recognizer")
    o.add_argument("--pool", default=None,
                   help="npz of pre-rendered lines (default: render each batch, as JAX does)")
    o.add_argument("--out", required=True, help="the weights file to write")
    o.add_argument("--steps", type=int, default=6000)
    o.add_argument("--batch-size", type=int, default=64)
    o.add_argument("--device", default=None, help="torch device (default: the card)")
    o.set_defaults(fn=_cmd_train_ocr)

    a = sub.add_parser("app", help="launch the Streamlit UI")
    a.set_defaults(fn=_cmd_app)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
