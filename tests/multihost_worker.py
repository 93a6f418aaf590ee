"""Worker process for the real multi-host test (launched by
test_multihost.py, 2 processes over the CPU backend).

Each process owns 4 virtual CPU devices (XLA_FLAGS set by the parent), joins
the cluster via jax.distributed.initialize, decodes ONLY its slice of every
global batch (ImageFolderDataset.batches(process_index=...)), assembles the
global sharded array via prefetch_to_device's
make_array_from_process_local_data path, and runs real pretrain train steps
whose gradient all-reduce XLA inserts across the process boundary.
"""

import argparse
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--data_root", required=True)
    args = ap.parse_args()

    import jax

    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id)
    assert jax.process_count() == args.num_processes, jax.process_count()
    assert jax.local_device_count() == 4, jax.local_device_count()
    assert jax.device_count() == 4 * args.num_processes, jax.device_count()

    from multi_style_transfer_gan.parallel import (
        make_mesh_for_batch, data_sharding,
    )
    from multi_style_transfer_gan.data.dataset import (
        ImageFolderDataset, prefetch_to_device,
    )
    from multi_style_transfer_gan.ops import to_model_range
    from multi_style_transfer_gan.train.pretrain import (
        pretrain_init_state, pretrain_train_step,
    )

    GLOBAL_BATCH = 8
    mesh = make_mesh_for_batch(GLOBAL_BATCH)
    assert mesh.shape["data"] == 4 * args.num_processes
    sharding = data_sharding(mesh)

    ds = ImageFolderDataset(args.data_root, "A", "train", host_size=32)
    it = ds.batches(GLOBAL_BATCH, seed=0, epochs=1,
                    process_index=jax.process_index(),
                    process_count=jax.process_count())

    local_shapes = []

    def slices():
        for b in it:
            local_shapes.append(b.shape)
            yield to_model_range(b)

    state, tx = pretrain_init_state(jax.random.PRNGKey(0), channels=4,
                                    num_epochs=1, steps_per_epoch=2)
    step = jax.jit(lambda s, x, k: pretrain_train_step(s, tx, x, k))

    losses = []
    for i, xb in enumerate(prefetch_to_device(slices(), sharding)):
        assert xb.shape[0] == GLOBAL_BATCH, xb.shape  # global logical shape
        state, loss = step(state, xb, jax.random.PRNGKey(i))
        losses.append(round(float(loss), 6))

    # each process decoded exactly half of every global batch
    assert all(s[0] == GLOBAL_BATCH // args.num_processes
               for s in local_shapes), local_shapes
    assert len(losses) >= 2, losses
    print(f"MULTIHOST_OK process={jax.process_index()} "
          f"steps={len(losses)} losses={losses}", flush=True)


if __name__ == "__main__":
    main()
