"""Multi-device serving: shard the decode -> preprocess pipeline over a
mesh.

Staged batches are split over the mesh's "data" axis and the preprocess
runs on every position, each on its own device and stream; there are no
collectives on the hot path. A port mesh may repeat a device, so the
sample runs anywhere: with fewer cards than positions the cards are
used round-robin, and ``--device cpu`` puts every position on the CPU.

Usage: python -m vali_tpu_torch.samples.sample_multichip [video]
           [n_devices] [batches] [--device cuda|cpu]
"""

import torch

from . import clip_argument, command_line
from ..parallel.mesh import make_mesh
from ..pipeline.multistream import MultiStreamPipeline
from ..utils.device import num_devices


def positions(device, n):
    """``n`` mesh positions: the CPU ``n`` times, or the cards
    round-robin (``device``'s card first)."""
    if device.type != "cuda":
        return [device] * n
    first, cards = device.index or 0, num_devices()
    return [torch.device("cuda", (first + i) % cards) for i in range(n)]


def run(sources, device, n_dev, n_batches, on_batch=None):
    """``n_batches`` batches of ``sources`` sharded over an ``n_dev``
    data mesh; ``on_batch(batch, ids)`` sees every batch (a
    ``parallel/mesh.ShardedTensor``). Returns the batches done."""
    mesh = make_mesh(data=n_dev, devices=positions(device, n_dev))
    print(f"mesh: {mesh.shape} over {[str(d) for d in mesh.devices.flat]}")

    pipe = MultiStreamPipeline(sources, dst_w=224, dst_h=224,
                               batch_size=n_dev * 2, mesh=mesh)
    done = 0
    for batch, ids in pipe:
        per_pos = sorted(s.data.shape[0] for s in batch.shards)
        if on_batch is not None:
            on_batch(batch, ids)
        print(f"batch {done}: {batch.shape} sharded as {per_pos} "
              f"frames/position across {len(batch.shards)} positions on "
              f"{len(batch.device_set)} device(s); "
              f"mean={batch.gather().float().mean().item():.1f}")
        done += 1
        if done >= n_batches:
            pipe.stop()
            break
    if done != n_batches:
        raise RuntimeError(f"{done} batches, expected {n_batches}")
    print(f"OK: {done} sharded batches across {n_dev} devices")
    return done


def main(argv=None):
    device, args = command_line(argv, "sample_multichip")
    n_dev = int(args[1]) if len(args) > 1 else 4
    n_batches = int(args[2]) if len(args) > 2 else 4
    with clip_argument(args) as uri:
        run([uri] * n_dev, device, n_dev, n_batches)


if __name__ == "__main__":
    main()
