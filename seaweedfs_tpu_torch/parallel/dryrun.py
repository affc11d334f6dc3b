"""The multi-device dry run and the one-step entry, twins of the JAX
package's entry points (`__graft_entry__.entry` and
`dryrun_multichip`).

- `entry(device)`: the RS(10,4) encode of a [10, 65536] stripe, as a
  callable and its example input on `device` (None: the card).
- `dryrun_multichip(n, devices)`: one step of every sharding the mesh
  has, on tiny shapes: a (n/2, 2) (volume x column) mesh, the batched
  encode with the shard-placement exchange, and a column-split rebuild
  of two lost shards of volume 0; then a (3, 2) mesh when n >= 6, whose
  14 shard rows over 3 groups take the uneven pad (S = 15, one pad row
  per group).  `devices` as `mesh.make_mesh` takes it: the CPU tests
  pass eight "cpu" positions, a one-card host eight of its card.

    python -m seaweedfs_tpu_torch.parallel.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from seaweedfs_tpu_torch.models import rs
from seaweedfs_tpu_torch.ops import gf, gf_cuda
from seaweedfs_tpu_torch.parallel import mesh as pmesh


def entry(device=None):
    """(forward, (example,)): the RS(10,4) encode [10, 65536] ->
    [14, 65536] on `device`, its input drawn from seed 0."""
    codec = gf_cuda.get_codec(10, 4, device=device)

    def forward(data: torch.Tensor) -> torch.Tensor:
        return codec.encode(data)

    rng = np.random.default_rng(0)
    example = torch.from_numpy(
        rng.integers(0, 256, (10, 65536), dtype=np.uint8)).to(codec.device)
    return forward, (example,)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the mesh's shardings once over `n_devices` positions of
    `devices` (None: every card), asserting as the reference does.
    Raises when fewer positions are given or found.  Returns each
    mesh's volumes, placed result and rebuilt shard 2, by (vol, col)."""
    positions = pmesh.mesh_devices(devices)
    if len(positions) < n_devices:
        raise ValueError(f"dry run over {n_devices} positions, "
                         f"{len(positions)} given")
    code = rs.get_code(10, 4)
    rng = np.random.default_rng(1)
    out = {}

    def run_mesh(vol_dim: int, col_dim: int) -> None:
        mesh = pmesh.make_mesh(vol_dim * col_dim, ("vol", "col"),
                               shape=(vol_dim, col_dim), devices=positions)
        enc = pmesh.ShardedRSEncoder(code, mesh, col_axis="col",
                                     vol_axis="vol")
        V = 2 * vol_dim
        n = col_dim * 512
        vols = rng.integers(0, 256, (V, 10, n), dtype=np.uint8)
        # batched encode + the shard-placement exchange
        placed = enc.encode_batch_place(vols)
        S = enc.placement_groups()
        assert placed.shape == (V, S, n), placed.shape
        # column-split rebuild of two lost shards of volume 0
        host = placed.numpy()
        shards = host[0][:14]
        survivors = {i: shards[i] for i in range(14) if i not in (2, 12)}
        rebuilt = enc.reconstruct(survivors)
        got = rebuilt[2].numpy()
        want = vols[0][2]  # systematic: shard 2 is data row 2
        assert np.array_equal(got, want), "multichip rebuild mismatch"
        parity = gf.gf_matmul(code.parity_matrix, vols[0])
        assert np.array_equal(rebuilt[12].numpy(), parity[2]), \
            "multichip rebuild mismatch"
        out[(vol_dim, col_dim)] = {"volumes": vols,
                                   "placed": host,
                                   "rebuilt": got}

    # primary shape: volumes (dp-like) x byte columns (sp-like)
    vol_dim = max(1, n_devices // 2)
    col_dim = n_devices // vol_dim
    run_mesh(vol_dim, col_dim)
    # the uneven pad: 14 shard rows over 3 volume groups
    if n_devices >= 6 and (vol_dim, col_dim) != (3, 2):
        run_mesh(3, 2)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="each of the 8 positions (default: every card, "
                         "at least 8)")
    args = ap.parse_args()
    dryrun_multichip(8, None if args.device is None else [args.device] * 8)
    print("dryrun_multichip(8) ok")
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry ok:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()
