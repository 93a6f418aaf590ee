"""CLI: batch folder processing (batch_process_images.py:541-597 flags).

Model files follow the reference's fixed layout under --models_dir
(default ./models): cyclegan_epoch_200.pth, G_AB_epoch_200.pth,
G_BA_epoch_200.pth (batch_process_images.py:66,91,107).
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="batch style-transfer processing")
    p.add_argument("--input_dir", type=str, default="test_images")
    p.add_argument("--output_dir", type=str, default="output/batch")
    p.add_argument("--mode", choices=["cyclegan", "local_style"],
                   default="cyclegan")
    p.add_argument("--direction", choices=["photo2monet", "monet2photo"],
                   default="photo2monet")
    p.add_argument("--local_style_mode",
                   choices=["simple", "enhanced", "advanced"],
                   default="enhanced")
    p.add_argument("--strength", type=float, default=0.8)
    p.add_argument("--detail", type=float, default=0.7)
    p.add_argument("--enhance_colors", action="store_true", default=True)
    p.add_argument("--no_enhance_colors", dest="enhance_colors",
                   action="store_false")
    p.add_argument("--smooth", action="store_true", default=True)
    p.add_argument("--no_smooth", dest="smooth", action="store_false")
    # additions (the reference runs batch=1 serially)
    p.add_argument("--models_dir", type=str, default="models")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 generator compute (the fast path)")
    p.add_argument("--engine", choices=["auto", "nhwc", "packed"],
                   default="auto",
                   help="generator engine: auto (default) = nhwc "
                        "(pipelines.batch.resolve_engine); packed = "
                        "space-to-depth forward (enhanced models only)")
    p.add_argument("--canvas", type=int, default=256,
                   help="working resolution (multiple of 32; the reference"
                        " fixes 256. 512 = higher fidelity, ~4x compute)")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard batches over all devices (jax.sharding mesh)")
    args = p.parse_args(argv)

    from ..utils import enable_compilation_cache
    enable_compilation_cache()
    from ..pipelines import load_generator, batch_process

    if args.mode == "cyclegan":
        path = os.path.join(args.models_dir, "cyclegan_epoch_200.pth")
        prefer = ("G_AB_state_dict" if args.direction == "monet2photo"
                  else "G_BA_state_dict")
        if not os.path.exists(path):
            print(f"error: missing CycleGAN model at {path}")
            return 1
        model = load_generator(path, prefer=prefer)
    else:
        name = ("G_AB_epoch_200.pth" if args.direction == "monet2photo"
                else "G_BA_epoch_200.pth")
        path = os.path.join(args.models_dir, name)
        if not os.path.exists(path):
            print(f"error: missing enhanced model at {path}")
            return 1
        model = load_generator(path)
    print(f"loaded {model.kind} generator (channels={model.channels})")

    mesh = None
    if args.data_parallel:
        import jax

        from ..parallel import make_mesh

        mesh = make_mesh()
        print(f"data-parallel over {len(jax.devices())} devices")

    import jax.numpy as jnp

    batch_process(model, args.input_dir, args.output_dir, mode=args.mode,
                  local_style_mode=args.local_style_mode,
                  direction=args.direction, strength=args.strength,
                  detail=args.detail, enhance_colors=args.enhance_colors,
                  smooth=args.smooth, batch_size=args.batch_size,
                  compute_dtype=jnp.bfloat16 if args.bf16 else None,
                  mesh=mesh, engine=args.engine, canvas=args.canvas)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
