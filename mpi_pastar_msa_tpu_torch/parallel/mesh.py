"""The shard meshes of the multi-device engine (parallel/sharded.py).

The JAX engine runs its sharded step inside ``shard_map`` over a
``jax.sharding.Mesh`` axis and moves data with the axis's collectives.  The
port's mesh is an object that holds some of the ``ndev`` shards (``local``,
their indices, on ``devices``) and runs the same four collectives on the
list of its shards' tensors, each op returning one tensor a local shard:

  all_to_all      (ndev, cap, F) a shard -> (ndev, cap, F): row block j of
                  shard i goes to row block i of shard j (``_route_cap``
                  :148-150)
  all_to_all_ragged  the ragged form: shard i sends rows
                  send_off[i][j] .. + sizes[i][j] of its buffer to shard
                  j, which receives them in sender order from row 0 of its
                  output (``_route_ragged`` :214-233)
  all_gather      (k,) a shard -> (ndev, k) (``_consensus`` :319, the
                  ragged send counts :214)
  reduce_scatter  (ndev B, F) a shard -> (B, F): the sum over shards of
                  rows i B .. (i + 1) B for shard i (``_sharded_h3`` :307)
  all_sum         the elementwise sum over shards (the walk's round :521)

Two meshes:
  LocalMesh(devices)  every shard in this process, on a list of devices
                      that may repeat (``[cuda:0] * 4``: four shards on one
                      card); a collective is tensor copies, peer copies
                      between cards.
  ProcessMesh()       one shard a rank of torch.distributed (gloo for CPU
                      tensors, NCCL for CUDA ones); ``init_distributed``
                      (parallel/multihost.py) starts the group.
Sizes given to the ragged op are host integers: the caller has read them.
The mesh serves the host driver's mesh form of the sharded step; the
chunked driver's card form reads its peers' buffers by address instead
(parallel/sharded.py).
"""
from __future__ import annotations

from typing import List, Sequence

import torch


class LocalMesh:
    """All ``ndev`` shards in this process, shard i on ``devices[i]``."""

    def __init__(self, devices: Sequence):
        if len(devices) < 1:
            raise ValueError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.ndev = len(self.devices)
        self.local = list(range(self.ndev))
        self.multiprocess = False

    def all_to_all(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        out = [torch.empty_like(x, device=self.devices[j]) for j, x in enumerate(xs)]
        for i, x in enumerate(xs):
            for j in range(self.ndev):
                out[j][i].copy_(x[j], non_blocking=True)
        return out

    def all_to_all_ragged(self, xs, send_off, sizes, outs) -> None:
        """Into ``outs`` (one a shard, rows from 0 in sender order)."""
        at = [0] * self.ndev
        for i, x in enumerate(xs):
            for j in range(self.ndev):
                n = int(sizes[i][j])
                if n:
                    o = int(send_off[i][j])
                    outs[j][at[j]:at[j] + n].copy_(x[o:o + n], non_blocking=True)
                    at[j] += n

    def all_gather(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        full = {}
        for d in self.devices:
            if d not in full:
                full[d] = torch.stack([x.to(d, non_blocking=True) for x in xs])
        return [full[d] for d in self.devices]

    def reduce_scatter(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        B = xs[0].shape[0] // self.ndev
        out = []
        for j, d in enumerate(self.devices):
            acc = xs[0][j * B:(j + 1) * B].to(d, copy=True)
            for x in xs[1:]:
                acc += x[j * B:(j + 1) * B].to(d, non_blocking=True)
            out.append(acc)
        return out

    def all_sum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        full = {}
        for d in self.devices:
            if d not in full:
                full[d] = sum(x.to(d) for x in xs[1:]) + xs[0].to(d)
        return [full[d] for d in self.devices]


class ProcessMesh:
    """One shard a rank of the default torch.distributed group, on
    ``device`` (the rank's card, or the CPU)."""

    def __init__(self, device):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs torch.distributed: call "
                               "parallel.multihost.init_distributed first")
        self._dist = dist
        self.ndev = dist.get_world_size()
        self.rank = dist.get_rank()
        self.local = [self.rank]
        self.devices = [torch.device(device)]
        self.multiprocess = self.ndev > 1
        if self.devices[0].type == "cuda":
            torch.cuda.set_device(self.devices[0])  # NCCL's and the kernels' card

    def all_to_all(self, xs):
        (x,) = xs
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x.contiguous())
        return [out]

    def all_to_all_ragged(self, xs, send_off, sizes, outs) -> None:
        (x,), (out,) = xs, outs
        me = self.rank
        send = [int(sizes[me][j]) for j in range(self.ndev)]
        recv = [int(sizes[i][me]) for i in range(self.ndev)]
        start = int(send_off[me][0]) if self.ndev else 0
        inp = x[start:start + sum(send)].contiguous()
        dst = torch.empty((sum(recv),) + tuple(out.shape[1:]), dtype=out.dtype,
                          device=out.device)
        self._dist.all_to_all_single(dst, inp, output_split_sizes=recv,
                                     input_split_sizes=send)
        out[:sum(recv)].copy_(dst)

    def all_gather(self, xs):
        (x,) = xs
        out = torch.empty((self.ndev * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._dist.all_gather_into_tensor(out, x.contiguous())
        return [out.view((self.ndev,) + tuple(x.shape))]

    def reduce_scatter(self, xs):
        (x,) = xs
        out = torch.empty((x.shape[0] // self.ndev,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._dist.reduce_scatter_tensor(out, x.contiguous())
        return [out]

    def all_sum(self, xs):
        (x,) = xs
        x = x.clone()
        self._dist.all_reduce(x)
        return [x]
