"""CLI: masked-inpainting pretraining (pretrain.py + pretrain_resume.py).

Reference surface: trains the plain Generator on both domains with the
random-patch mask, cosine LR, checkpoints every 50 epochs (pretrain.py:
99-230); --resume restores a checkpoint like pretrain_resume.py:134-157.

Additions: real batch sizes over a data-parallel mesh (the reference is
locked to batch=1) and an async host->device input pipeline.
"""

import argparse
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="masked-inpainting pretraining")
    p.add_argument("--data_root", type=str, required=True,
                   help="monet2photo root containing trainA/trainB")
    p.add_argument("--save_dir", type=str, default="models")
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--model", choices=["plain", "enhanced"], default="plain",
                   help="plain = the reference recipe (Generator(64)); "
                        "enhanced = pretrain the EnhancedGenerator itself "
                        "so cli.train's --pretrained warm start actually "
                        "transfers (the reference's plain->enhanced "
                        "non-strict load shares zero keys)")
    p.add_argument("--num_transformer_blocks", type=int, default=1,
                   help="enhanced model only")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume from (pretrain_resume parity)")
    p.add_argument("--checkpoint_every", type=int, default=50)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--metrics_log", type=str, default=None,
                   help="append one JSON line per logged step/epoch here")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 compute — the default (the reference pretrain "
                        "runs torch autocast by default, pretrain.py:160; "
                        "bf16 needs no loss scaling)")
    p.add_argument("--fp32", action="store_true",
                   help="full fp32 compute (overrides the bf16 default)")
    args = p.parse_args(argv)

    from ..utils import enable_compilation_cache, MetricsLogger
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    # only process 0 writes metrics on a pod (all processes see all losses)
    metrics = MetricsLogger(args.metrics_log
                            if jax.process_index() == 0 else None)

    from ..data import ImageFolderDataset, prefetch_to_device
    from ..ops import to_model_range
    from ..parallel import make_mesh_for_batch, data_sharding, replicate_tree
    from ..train import (
        pretrain_init_state, pretrain_train_step, save_pretrain_checkpoint,
    )
    from ..train.pretrain import PretrainState
    from ..weights import load_pth, extract_state_dict, plain_generator_from_sd

    monet = ImageFolderDataset(args.data_root, "A", host_size=256)
    photo = ImageFolderDataset(args.data_root, "B", host_size=256)
    print(f"monet images: {len(monet)}  photo images: {len(photo)}")
    steps_per_epoch = ((len(monet) + len(photo)) // args.batch_size) or 1

    key = jax.random.PRNGKey(args.seed)
    state, tx = pretrain_init_state(
        key, args.channels, num_epochs=args.num_epochs,
        steps_per_epoch=steps_per_epoch, lr=args.lr, model=args.model,
        num_transformer_blocks=args.num_transformer_blocks)
    start_epoch = 0
    if args.resume:
        from ..train.pretrain import restore_opt_state

        ck = load_pth(args.resume)
        if args.model == "enhanced":
            from ..weights import enhanced_generator_from_sd

            params = enhanced_generator_from_sd(extract_state_dict(ck))
        else:
            params = plain_generator_from_sd(extract_state_dict(ck))
        start_epoch = int(ck.get("epoch", 0)) + 1
        step = start_epoch * steps_per_epoch
        # fast-forwards the LR schedule/bias-correction counts and restores
        # adam moments when the checkpoint carries a torch Adam state
        opt = restore_opt_state(tx, params, step,
                                ck.get("optimizer_state_dict"),
                                kind=args.model)
        state = PretrainState(params=params, opt=opt,
                              step=jnp.asarray(step))
        print(f"resumed from {args.resume} at epoch {start_epoch}")

    mesh = make_mesh_for_batch(args.batch_size)
    sharding = data_sharding(mesh)
    state = replicate_tree(state, mesh)
    # donate the state: in-place param/opt buffer reuse on device.
    # uint8 inputs, normalized inside the jitted step (4x less H2D; no
    # per-step eager ops — see cli/train.py's leak note)
    from ..ops import to_model_range as _tmr

    dtype = jnp.float32 if args.fp32 else jnp.bfloat16
    step_fn = jax.jit(lambda s, x, k: pretrain_train_step(
        s, tx, _tmr(x), k, compute_dtype=dtype), donate_argnums=0)

    os.makedirs(args.save_dir, exist_ok=True)
    mask_key = jax.random.PRNGKey(args.seed + 1)
    try:
        _run_epochs(args, monet, photo, state, step_fn, sharding, mask_key,
                    metrics, start_epoch)
    finally:
        metrics.close()


def _run_epochs(args, monet, photo, state, step_fn, sharding, mask_key,
                metrics, start_epoch):
    import jax

    from ..data import prefetch_to_device
    from ..ops import to_model_range
    from ..train import save_pretrain_checkpoint

    for epoch in range(start_epoch, args.num_epochs):
        t0 = time.time()
        epoch_total, epoch_count = 0.0, 0  # across BOTH domains
        for name, ds in (("monet", monet), ("photo", photo)):
            it = ds.batches(args.batch_size, seed=args.seed + epoch, epochs=1,
                            process_index=jax.process_index(),
                            process_count=jax.process_count())
            it = ((b,) for b in it)  # uint8; step normalizes in-jit
            total, count = 0.0, 0
            for i, (imgs,) in enumerate(prefetch_to_device(it, sharding)):
                mask_key, sub = jax.random.split(mask_key)
                state, loss = step_fn(state, imgs, sub)
                total += float(loss)
                count += 1
                if (i + 1) % args.log_every == 0:
                    print(f"  epoch {epoch + 1} [{name}] step {i + 1}: "
                          f"loss {total / count:.4f}")
                    metrics.log(epoch=epoch + 1, domain=name, step=i + 1,
                                loss=total / count)
            epoch_total += total
            epoch_count += count
            if count:
                print(f"epoch {epoch + 1} [{name}]: mean loss "
                      f"{total / count:.4f}")
                metrics.log(epoch=epoch + 1, domain=name,
                            mean_loss=total / count)
        if (epoch + 1) % args.checkpoint_every == 0:
            path = os.path.join(args.save_dir,
                                f"generator_pretrain_epoch_{epoch + 1}.pth")
            save_pretrain_checkpoint(state, path, epoch,
                                     epoch_total / max(epoch_count, 1))
            print(f"checkpoint saved: {path}")
        print(f"epoch {epoch + 1}/{args.num_epochs} done "
              f"({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
