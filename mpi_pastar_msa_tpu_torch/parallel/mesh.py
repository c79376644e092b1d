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
Every other op writes into ``outs`` (one preallocated tensor a local
shard) when it is given, allocates nothing and reads no value on the
host, so a CUDA graph may hold it: on a ProcessMesh the NCCL call itself
(captured into each rank's step graph), on a LocalMesh copies and in-place
sums.  Without ``outs`` it allocates its outputs.  The meshes serve the
sharded step's rank form (one shard a rank); the card form of a LocalMesh
reads its peers' buffers by address instead (parallel/sharded.py).

``map_peers`` gives every shard's buffer of one kind (the wires) where
this process's kernels read it, so that the rank form's ragged exchange
reads its senders' wires by address, as the card form does: on a
LocalMesh the tensors themselves, on a ProcessMesh of cards this rank's
own and each other rank's as a CUDA IPC mapping into this process, which
``unmap_peers`` closes at the run's end.
"""
from __future__ import annotations

import ctypes
import os
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

    def _outs(self, outs, shape, like: torch.Tensor) -> List[torch.Tensor]:
        if outs is not None:
            return list(outs)
        return [torch.empty(shape, dtype=like.dtype, device=d) for d in self.devices]

    def all_to_all(self, xs: List[torch.Tensor], outs=None) -> List[torch.Tensor]:
        outs = self._outs(outs, xs[0].shape, xs[0])
        for i, x in enumerate(xs):
            for j in range(self.ndev):
                outs[j][i].copy_(x[j], non_blocking=True)
        return outs

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

    def all_gather(self, xs: List[torch.Tensor], outs=None) -> List[torch.Tensor]:
        outs = self._outs(outs, (self.ndev,) + tuple(xs[0].shape), xs[0])
        for out in outs:
            for i, x in enumerate(xs):
                out[i].copy_(x, non_blocking=True)
        return outs

    def reduce_scatter(self, xs: List[torch.Tensor], outs=None) -> List[torch.Tensor]:
        B = xs[0].shape[0] // self.ndev
        outs = self._outs(outs, (B,) + tuple(xs[0].shape[1:]), xs[0])
        for j, out in enumerate(outs):
            out.copy_(xs[0][j * B:(j + 1) * B], non_blocking=True)
            for x in xs[1:]:
                out.add_(x[j * B:(j + 1) * B].to(out.device, non_blocking=True))
        return outs

    def map_peers(self, xs: List[torch.Tensor]) -> list:
        """Every shard's tensor of ``xs`` (one a shard): the tensors
        themselves, every shard being in this process."""
        return list(xs)

    def unmap_peers(self) -> None:
        """Nothing to close: ``map_peers`` maps nothing."""

    def all_sum(self, xs: List[torch.Tensor], outs=None) -> List[torch.Tensor]:
        """The sum into ``outs[0]``, then copied into the others: ``outs``
        may be ``xs`` (in place)."""
        outs = self._outs(outs, xs[0].shape, xs[0])
        total = outs[0]
        if total is not xs[0]:
            total.copy_(xs[0], non_blocking=True)
        for x in xs[1:]:
            total.add_(x.to(total.device, non_blocking=True))
        for out in outs[1:]:
            out.copy_(total, non_blocking=True)
        return outs


class ProcessMesh:
    """One shard a rank of the default torch.distributed group, on
    ``device`` (the rank's card, or the CPU).  Each op is one collective
    of the group on contiguous tensors; with ``outs`` it is NCCL's (or
    gloo's) call alone, on fixed shapes."""

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
        self._mapped: List[int] = []  # bases of the peers' mapped buffers
        if self.devices[0].type == "cuda":
            torch.cuda.set_device(self.devices[0])  # NCCL's and the kernels' card

    def all_to_all(self, xs, outs=None):
        (x,) = xs
        out = torch.empty_like(x) if outs is None else outs[0]
        self._dist.all_to_all_single(out, x)
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

    def all_gather(self, xs, outs=None):
        (x,) = xs
        shape = (self.ndev,) + tuple(x.shape)
        out = torch.empty(shape, dtype=x.dtype, device=x.device) if outs is None else outs[0]
        # the concatenated form of the (ndev, ...) stack, as gloo takes it too
        self._dist.all_gather_into_tensor(
            out.view((self.ndev * x.shape[0],) + tuple(x.shape[1:])), x)
        return [out]

    def reduce_scatter(self, xs, outs=None):
        (x,) = xs
        out = (torch.empty((x.shape[0] // self.ndev,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device) if outs is None else outs[0])
        self._dist.reduce_scatter_tensor(out, x)
        return [out]

    def all_sum(self, xs, outs=None):
        (x,) = xs
        out = torch.empty_like(x) if outs is None else outs[0]
        if out is not x:
            out.copy_(x)
        self._dist.all_reduce(out)
        return [out]

    def _agree(self, failure: str) -> None:
        """Every rank's ``failure`` ("" for none), gathered: raises on every
        rank if any rank failed, so that no rank goes on into a collective
        that a failed one never joins."""
        fails = [None] * self.ndev
        self._dist.all_gather_object(fails, failure)
        bad = [f"rank {r}: {f}" for r, f in enumerate(fails) if f]
        if bad:
            raise RuntimeError("mapping the peers' buffers failed: " + "; ".join(bad))

    def map_peers(self, xs) -> list:
        """Every rank's tensor of ``xs`` (this rank's one: a contiguous
        tensor on this rank's card, of one shape and type on every rank)
        where this rank's kernels read it: its own at ``rank``, each other
        rank's as the int device address of a CUDA IPC mapping of it into
        this process, opened on this rank's card (whatever card index the
        sender's process gives it).  The handles travel in one
        all_gather_object of the group; ``unmap_peers`` closes the
        mappings.  A mapping that cannot be made raises on every rank, with
        no fallback: a CPU mesh, memory that IPC handles cannot name
        (PyTorch's expandable segments), a failed open."""
        from .. import _kernels

        (x,) = xs
        dev = self.devices[0]
        if (dev.type != "cuda" or x.device.type != "cuda" or not x.is_contiguous()
                or dev.index not in (None, x.device.index)):
            raise ValueError(f"map_peers: a contiguous tensor on this rank's card {dev}, "
                             f"not {x.device}: a ProcessMesh on the CPU maps nothing")
        conf = ",".join(os.environ.get(k, "") for k in ("PYTORCH_CUDA_ALLOC_CONF",
                                                         "PYTORCH_ALLOC_CONF"))
        failure = ""
        if "expandable_segments:true" in conf.replace(" ", "").lower():
            failure = ("PyTorch's allocator runs with expandable segments, whose memory CUDA "
                       "IPC handles cannot name: unset expandable_segments")
        handle, offset = ctypes.create_string_buffer(64), ctypes.c_longlong()
        if not failure:
            try:
                with torch.cuda.device(dev):
                    _kernels.call("ipc_export", x.data_ptr(), ctypes.addressof(handle),
                                  ctypes.addressof(offset))
            except RuntimeError as e:
                failure = f"the IPC handle of the buffer: {e}"
        infos = [None] * self.ndev
        self._dist.all_gather_object(infos, (failure, handle.raw, offset.value,
                                             tuple(x.shape), str(x.dtype)))
        failure = next((f"rank {r}: {i[0]}" for r, i in enumerate(infos) if i[0]), "")
        if not failure and len({i[3:] for i in infos}) != 1:
            failure = f"buffers of several shapes or types: {[i[3:] for i in infos]}"
        if failure:
            raise RuntimeError(f"mapping the peers' buffers failed: {failure}")
        out: list = []
        for r, (_, h, off, _, _) in enumerate(infos):
            if r == self.rank:
                out.append(x)
                continue
            base, theirs = ctypes.c_void_p(), ctypes.create_string_buffer(h, len(h))
            try:
                with torch.cuda.device(dev):
                    _kernels.call("ipc_open", ctypes.addressof(theirs), ctypes.addressof(base))
            except RuntimeError as e:
                failure = f"opening rank {r}'s handle: {e}"
                break
            self._mapped.append(base.value)
            out.append(base.value + off)
        try:
            self._agree(failure)
        except RuntimeError:
            self._close()
            raise
        return out

    def unmap_peers(self) -> None:
        """Close this rank's mappings (``map_peers``) behind one barrier of
        the group, once this rank's card has finished its work: no rank
        frees or reuses a buffer while a peer's kernel may still read it."""
        torch.cuda.synchronize(self.devices[0])
        self._dist.barrier()
        self._close()

    def _close(self) -> None:
        from .. import _kernels

        bases, self._mapped = self._mapped, []
        with torch.cuda.device(self.devices[0]):
            for base in bases:
                _kernels.call("ipc_close", base)
