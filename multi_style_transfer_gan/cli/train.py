"""CLI: enhanced CycleGAN training (enhanced_train.py surface).

Reference: EnhancedCycleGAN(channels=16, 1 transformer block), optional
pretrain warm-start, zip of monet/photo loaders, three .pth checkpoints
every 20 epochs (enhanced_train.py:154-208). Additions: batched +
data-parallel over the mesh, single jitted train step.
"""

import argparse
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="enhanced CycleGAN training")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="models")
    p.add_argument("--pretrained", type=str, default=None)
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--num_transformer_blocks", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint_every", type=int, default=20)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 compute — the default, mirroring the "
                        "reference's AMP-by-default training "
                        "(enhanced_train.py:46)")
    p.add_argument("--fp32", action="store_true",
                   help="full fp32 compute (overrides the bf16 default)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize generator stages in backward "
                        "(the reference's gradient-checkpointing mode, "
                        "enhanced_train.py:24-25). Off by default; enable "
                        "for large batch/resolution runs that run out of "
                        "device memory")
    p.add_argument("--lr_decay", action="store_true",
                   help="CycleGAN-paper LR schedule: constant for the "
                        "first half of training, linear to zero over the "
                        "second half. OFF by default (the reference holds "
                        "LRs constant, enhanced_train.py:36-43); measured "
                        "motivation in docs/TRAINED_STUDY.md (late-phase "
                        "adversarial drift under constant LRs)")
    p.add_argument("--pool_size", type=int, default=0,
                   help="discriminator replay buffer (the CycleGAN paper's "
                        "image pool, 50 in the paper): D scores fakes "
                        "sampled from a device-resident history instead of "
                        "only the current batch. 0 (default) = the "
                        "reference's behavior (enhanced_train.py:66-85); "
                        "motivation in docs/TRAINED_STUDY.md (late-phase "
                        "adversarial drift)")
    p.add_argument("--metrics_log", type=str, default=None,
                   help="append one JSON line per logged step/epoch here")
    p.add_argument("--image_size", type=int, default=256,
                   help="training resolution (reference fixes 256)")
    p.add_argument("--resume_dir", type=str, default=None,
                   help="orbax checkpoint dir: full native resume (params"
                        " + optimizer moments + spectral-norm buffers +"
                        " epoch); checkpoints are written there every"
                        " --checkpoint_every alongside the .pth exports")
    args = p.parse_args(argv)

    from ..utils import enable_compilation_cache, MetricsLogger
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    # only process 0 writes metrics on a pod (all processes see all losses)
    metrics = MetricsLogger(args.metrics_log
                            if jax.process_index() == 0 else None)

    from ..data import ImageFolderDataset, prefetch_to_device
    from ..parallel import make_mesh_for_batch, data_sharding, replicate_tree
    from ..train import cyclegan_init_state, save_models
    from ..train.cyclegan import make_optimizers, make_train_step
    from ..weights import load_pth, extract_state_dict, plain_generator_from_sd

    pre = None
    if args.pretrained and not os.path.exists(args.pretrained):
        # a typo'd path must not silently train from scratch — the silent
        # version of this cost a full (wasted) warm-start-less run; it is
        # also the failure the reference's own strict=False load hides
        # (enhanced_train.py:28-33)
        raise SystemExit(f"--pretrained {args.pretrained} does not exist")
    if args.pretrained:
        print(f"warm-starting generators from {args.pretrained}")
        pre_sd = extract_state_dict(load_pth(args.pretrained))
        from ..weights import enhanced_generator_from_sd
        try:
            pre = enhanced_generator_from_sd(pre_sd)
        except Exception:
            pre = plain_generator_from_sd(pre_sd)

    monet = ImageFolderDataset(args.data_root, "A",
                               img_size=args.image_size,
                               host_size=args.image_size)
    photo = ImageFolderDataset(args.data_root, "B",
                               img_size=args.image_size,
                               host_size=args.image_size)
    print(f"monet: {len(monet)}  photo: {len(photo)}")

    decay_steps = None
    if args.lr_decay:
        # steps/epoch from the smaller domain (zip truncates to it)
        spe = min(len(monet), len(photo)) // args.batch_size or 1
        decay_steps = args.num_epochs * spe
        print(f"lr_decay: constant to step {decay_steps // 2}, then "
              f"linear to 0 at {decay_steps}")
    g_tx, d_tx = make_optimizers(decay_steps=decay_steps)
    # the state's optimizer trees must come from the SAME pair the loop
    # steps with (a scheduled adam carries a count in its state)
    state = cyclegan_init_state(jax.random.PRNGKey(args.seed), args.channels,
                                args.num_transformer_blocks,
                                pretrained_params=pre, txs=(g_tx, d_tx))
    mesh = make_mesh_for_batch(args.batch_size)
    sharding = data_sharding(mesh)
    dtype = jnp.float32 if args.fp32 else jnp.bfloat16
    pools = None
    if args.pool_size > 0:
        from ..train.pool import pool_init

        pools = ((pool_init(args.pool_size, args.image_size, dtype),
                  pool_init(args.pool_size, args.image_size, dtype)),
                 jax.random.PRNGKey(args.seed + 1))
        print(f"image pool: {args.pool_size} per direction, on device")

    start_epoch = 0
    if args.resume_dir:
        from ..train.checkpoint import latest_step, restore_train_state

        if latest_step(args.resume_dir) is not None:
            # the pool (buffer + fill count + PRNG key) is part of the run's
            # D-phase distribution, so it resumes with the rest of the state;
            # a pool-free checkpoint (older run, or --pool_size newly added)
            # falls back to restoring the bare state with a fresh pool.
            if pools is not None:
                try:
                    (state, pools), start_epoch = restore_train_state(
                        args.resume_dir, None, (state, pools))
                except Exception:
                    state, start_epoch = restore_train_state(
                        args.resume_dir, None, state)
                    print("checkpoint has no pool state; resuming with a "
                          "fresh (empty) image pool")
            else:
                state, start_epoch = restore_train_state(args.resume_dir,
                                                         None, state)
            print(f"resumed from {args.resume_dir} at epoch {start_epoch}")
        else:
            print(f"no checkpoints under {args.resume_dir}; starting fresh")
    state = replicate_tree(state, mesh)
    if pools is not None:
        pools = replicate_tree(pools, mesh)
    step_fn = make_train_step(g_tx, d_tx, compute_dtype=dtype,
                              remat=args.remat, pools=pools is not None)

    try:
        for epoch in range(start_epoch, args.num_epochs):
            t0 = time.time()
            # batches stay host numpy until prefetch: on a multi-host pod
            # each process decodes only its slice and prefetch assembles the
            # global sharded array (make_array_from_process_local_data)
            it_a = monet.batches(args.batch_size, seed=args.seed + epoch,
                                 epochs=1,
                                 process_index=jax.process_index(),
                                 process_count=jax.process_count())
            it_b = photo.batches(args.batch_size, seed=args.seed * 7 + epoch,
                                 epochs=1, process_index=jax.process_index(),
                                 process_count=jax.process_count())
            paired = zip(it_a, it_b)  # uint8 host batches (see step_fn)
            steps = 0
            for i, (xa, xb) in enumerate(prefetch_to_device(paired, sharding)):
                if pools is not None:
                    state, losses, pools = step_fn(state, pools, xa, xb)
                else:
                    state, losses = step_fn(state, xa, xb)
                steps = i + 1
                if (i + 1) % args.log_every == 0:
                    vals = {k: float(v) for k, v in losses.items()}
                    msg = " ".join(f"{k}={v:.4f}" for k, v in vals.items())
                    print(f"epoch {epoch + 1} step {i + 1}: {msg}")
                    metrics.log(epoch=epoch + 1, step=i + 1, **vals)
            if (epoch + 1) % args.checkpoint_every == 0:
                save_models(jax.device_get(state), args.save_dir, epoch + 1)
                if args.resume_dir:
                    from ..train.checkpoint import save_train_state

                    save_train_state(state if pools is None
                                     else (state, pools),
                                     args.resume_dir, epoch + 1)
                print(f"checkpoints saved at epoch {epoch + 1}")
            dt = time.time() - t0
            print(f"epoch {epoch + 1}/{args.num_epochs} done ({dt:.1f}s)")
            metrics.log(epoch=epoch + 1, epoch_seconds=dt,
                        img_pairs_per_sec=steps * args.batch_size
                        / max(dt, 1e-9))
    finally:
        metrics.close()


if __name__ == "__main__":
    main()
