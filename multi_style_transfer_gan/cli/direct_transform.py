"""CLI: single-image transform (direct_transform.py:201-223 flag surface)."""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="single-image style transfer")
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--output", type=str, default="output.png")
    p.add_argument("--test_sizes", action="store_true",
                   help="sweep 128/256/512/768 and save a comparison grid")
    p.add_argument("--test_skip", action="store_true",
                   help="blend output with input at 50/30/10%%")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--precision", choices=["default", "high", "highest"],
                   default="default")
    p.add_argument("--spatial", type=int, default=0,
                   help="shard the image height over N devices (for sizes "
                        "whose activations outgrow one device; size must "
                        "be divisible by 16*N)")
    args = p.parse_args(argv)

    from ..utils import enable_compilation_cache
    enable_compilation_cache()
    from ..pipelines import (
        load_generator, transform_image, test_different_sizes,
        try_skip_connections,
    )

    model = load_generator(args.model, precision=args.precision)
    print(f"loaded {model.kind} generator (channels={model.channels}, "
          f"direction={model.direction})")
    import os
    out_dir = os.path.dirname(os.path.abspath(args.output)) or "."
    if args.test_sizes:
        print(test_different_sizes(model, args.image, out_dir,
                                   spatial=args.spatial))
    elif args.test_skip:
        print(try_skip_connections(model, args.image, out_dir,
                                   spatial=args.spatial))
    else:
        transform_image(model, args.image, args.output, size=args.size,
                        spatial=args.spatial)
        print(f"saved: {args.output}")


if __name__ == "__main__":
    main()
