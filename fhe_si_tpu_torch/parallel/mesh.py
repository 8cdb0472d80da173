"""Meshes of torch.distributed ranks, and the sharding helpers.

Counterpart of fhe_si_tpu/parallel/mesh.py.  The JAX package lays its
devices out as a jax.sharding.Mesh and lets GSPMD (or jax.shard_map, in
parallel/shard.py) place the collectives.  Here every rank is one process
of the default process group with one device; it holds its block of each
sharded tensor and runs the pipelines of parallel/shard.py on it, with
the collectives written out (Mesh.psum).  The axes:

  'dp'    ciphertext batch: blocks are independent until the additive
          block reduce (Regression.h:102-149 semantics);
  'limb'  the CRT prime axis L: residue arithmetic and the transforms are
          per prime; only the CRT reconstruction couples primes
          (ShardedPipelines);
  'coeff' the phi(m) axis: everything but the transforms is per
          coefficient (CoeffShardedPipelines).

Start every rank with torch.distributed.init_process_group (address,
world size and rank given: nothing on the machine announces a cluster),
then build the same meshes in the same order on every rank, because
dist.new_group is collective.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from .shard import ShardedPipelines


class Mesh:
    """The ranks of the default process group on a grid with named axes,
    rank r at the row-major position r; this rank's coordinates and one
    process group per axis through it."""

    def __init__(self, axis_names, shape, device=None):
        """device: this rank's device; by default the CUDA card
        rank mod the number of cards (raises without CUDA: pass
        device='cpu' to run on the CPU)."""
        world, rank = dist.get_world_size(), dist.get_rank()
        shape = tuple(int(s) for s in shape)
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{math.prod(shape)} ranks; the world has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        grid = np.arange(world).reshape(shape)
        self.coords = {name: int(c) for name, c in
                       zip(self.axis_names, np.argwhere(grid == rank)[0])}
        self._groups = {}
        for ax, name in enumerate(self.axis_names):
            # every rank creates every group, in the same order
            for ranks in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]):
                group = dist.new_group([int(r) for r in ranks])
                if rank in ranks:
                    self._groups[name] = group
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; pass device='cpu' "
                                   "to run the mesh on the CPU")
            device = torch.device("cuda", rank % torch.cuda.device_count())
        self.device = torch.device(device)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def psum(self, t, axis: str):
        """The sum of t over the ranks along `axis` (dist.all_reduce,
        SUM), in every one of them."""
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._groups[axis])
        return t

    def all_gather(self, t, axis: str, dim: int = 0):
        """The blocks of the ranks along `axis`, joined along dim."""
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=self._groups[axis])
        return torch.cat(parts, dim)

    def block(self, t, dim: int, axis: str):
        """This rank's block of the whole tensor t (numpy or torch) along
        dimension dim, split evenly over the ranks of `axis`, as a
        contiguous tensor on self.device."""
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t))
        n, size = self.shape[axis], t.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over {axis}={n}")
        loc = size // n
        return t.narrow(dim, self.coords[axis] * loc, loc).contiguous().to(
            self.device)


def make_mesh(n_dp: int | None = None, n_limb: int = 1, device=None) -> Mesh:
    """('dp', 'limb') mesh; n_dp defaults to the world size over n_limb."""
    if n_dp is None:
        n_dp = dist.get_world_size() // n_limb
    return Mesh(("dp", "limb"), (n_dp, n_limb), device)


def make_coeff_mesh(n: int, device=None) -> Mesh:
    """('dp', 'coeff') mesh with n ranks on 'coeff' (the sequence-parallel
    analog, SURVEY §2 axis 2: shard phi(m)); the rest of the world on
    'dp'."""
    return Mesh(("dp", "coeff"), (dist.get_world_size() // n, n), device)


def shard_batched_parts(mesh: Mesh, parts):
    """This rank's block of a [B, k, phim, n] limb tensor: the batch over
    'dp' and, on a coeff mesh, phim over 'coeff'."""
    out = mesh.block(parts, 0, "dp")
    if "coeff" in mesh.shape:
        out = mesh.block(out, 2, "coeff")
    return out


def shard_limb(mesh: Mesh, t, l_axis: int):
    """This rank's block of a residue tensor along its prime axis l_axis."""
    return mesh.block(t, l_axis, "limb")


def shard_matrix(mesh: Mesh, matrix_evals):
    """A full-chain key-switch matrix [2, K, L, phim] (numpy, torch, or the
    JAX package's array as numpy) as this rank's block: its prime rows on
    a limb mesh, its phim columns on a coeff mesh."""
    if "limb" in mesh.shape:
        return shard_limb(mesh, matrix_evals, 2)
    return mesh.block(matrix_evals, 3, "coeff")


def sharded_mul_relin(dev, mesh: Mesh):
    """Batched mul+relinearize with the key-switch matrix sharded over
    'limb' and the ciphertext batch over 'dp', the results summed over
    the batch (the additive block merge of Regression.h:102-149).

    Torch has no GSPMD: this is the explicit pipeline of
    parallel/shard.py behind the JAX function's interface.  Returns
    fn(parts_a [B, ka, phim, n], parts_b, matrix [2, K, L, phim]), which
    every rank calls with the whole tensors (numpy or torch) and which
    returns, on every rank, the summed parts [2, phim, n_ct]: the value
    that adding the B products one by one with reduce_signed gives."""
    pipe = ShardedPipelines(dev.ctx, mesh)

    def step(a, b, matrix):
        return pipe.mul_relin_block_reduce(shard_batched_parts(mesh, a),
                                           shard_batched_parts(mesh, b),
                                           shard_matrix(mesh, matrix))
    return step
