"""Export a trained model's eval forward as a serving artifact (the
counterpart of agrl_tpu's tools/export_model.py).

Builds the arch like the training CLI (same hyper-parameter flags), loads
a checkpoint (an agrl_torch .pth.tar, a torch-named state dict, or an
agrl_tpu .msgpack converted by arch; shape-filtered like --load-weights,
and refused when partial unless --allow-partial), and writes the eval
forward captured by torch.export (agrl_torch/engine/export.py), bf16 by
default as agrl_tpu's. The artifact holds no weights; the serving host
reads them from a torch checkpoint. For a .msgpack the converted weights
are written beside the artifact, as <out stem>.weights.pth:

    python -m agrl_torch.cli.export_model -a vmgn --num-classes 625 \\
        --load-weights log/.../best_model.pth.tar --batch 64 --out vmgn_eval.pt2

    # serving side (no model code)
    from agrl_torch.core.checkpoint import load_variables
    from agrl_torch.engine.export import FeatureExtractor
    fx = FeatureExtractor.from_exported(
        "vmgn_eval.pt2", load_variables("log/.../best_model.pth.tar"))

The program runs on the device it was exported on: --device cuda (the
default; needs a card) or cpu.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-a", "--arch", default="vmgn",
                   help="an arch of agrl_torch's video registry (models.get_names())")
    p.add_argument("--num-classes", type=int, required=True,
                   help="classifier width the checkpoint was trained with")
    p.add_argument("--load-weights", required=True,
                   help="agrl_torch .pth.tar, torch state dict (.pth/.npz/.npy, reference "
                        "names) or agrl_tpu .msgpack checkpoint")
    # arch hyper-params (same names/defaults as the training CLI)
    p.add_argument("--last-stride", type=int, default=1)
    p.add_argument("--num-parts", type=int, default=3)
    p.add_argument("--num-scale", type=int, default=1)
    p.add_argument("--num-split", type=int, default=4)
    p.add_argument("--pyramid-part", action="store_true", default=False)
    p.add_argument("--num-gb", type=int, default=2)
    p.add_argument("--use-pose", action="store_true", default=False)
    p.add_argument("--learn-graph", action="store_true", default=False)
    p.add_argument("--bnneck", action="store_true", default=False)
    # export shape + options
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--no-bf16", action="store_true",
                   help="serve float32 (default: bf16-rounded weights, pixels and adjacency)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the artifact's program runs on")
    p.add_argument("--out", required=True, help="artifact output path (.pt2)")
    p.add_argument("--allow-partial", action="store_true",
                   help="export even if some checkpoint tensors did not "
                        "match (default: refuse — a mismatch usually means "
                        "the arch flags differ from the trained model)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from agrl_torch import models
    from agrl_torch.core.checkpoint import TORCH_CKPT_EXTS, load_any_checkpoint
    from agrl_torch.engine.export import export_eval_forward, save_exported

    model = models.init_model(
        args.arch,
        num_classes=args.num_classes,
        loss={"xent", "htri"},
        last_stride=args.last_stride,
        num_parts=args.num_parts,
        num_scale=args.num_scale,
        num_split=args.num_split,
        pyramid_part=args.pyramid_part,
        num_gb=args.num_gb,
        use_pose=args.use_pose,
        learn_graph=args.learn_graph,
        bnneck=args.bnneck,
        height=args.height,
        width=args.width,
        device="cpu",
    )
    matched, skipped = load_any_checkpoint(model, args.load_weights)
    print(f"Loaded {len(matched)} tensors from '{args.load_weights}'"
          + (f" ({len(skipped)} skipped)" if skipped else ""))
    if skipped and not args.allow_partial:
        preview = "\n  ".join(skipped[:8])
        raise SystemExit(
            f"{len(skipped)} checkpoint tensors did not match the built "
            f"model (first few:\n  {preview}\n). A serving artifact from a "
            "partial load is almost always a mis-specified arch — check "
            "--num-classes and the arch flags (--pyramid-part, --use-pose, "
            "--learn-graph, --num-gb, ...), or pass --allow-partial to "
            "export anyway."
        )
    if not args.load_weights.endswith(TORCH_CKPT_EXTS):
        weights_out = os.path.splitext(args.out)[0] + ".weights.pth"
        torch.save(model.state_dict(), weights_out)
        print(f"Wrote the converted weights -> {weights_out}")

    exp = export_eval_forward(
        model, model.state_dict(), batch_size=args.batch, seq_len=args.seq_len,
        height=args.height, width=args.width, bf16=not args.no_bf16, device=args.device,
    )
    save_exported(args.out, exp)
    size_kb = os.path.getsize(args.out) / 1024
    print(
        f"Exported {args.arch} eval forward (batch {args.batch}, "
        f"seq {args.seq_len}, {args.height}x{args.width}, "
        f"{'f32' if args.no_bf16 else 'bf16'}, "
        f"device {args.device}) -> {args.out} ({size_kb:.0f} KB)"
    )


if __name__ == "__main__":
    main()
