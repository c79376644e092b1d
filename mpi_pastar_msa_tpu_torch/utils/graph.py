"""Two things about the node a CUDA graph capture adds next on a stream,
through the driver API while the capture is open
(``cuStreamGetCaptureInfo_v3``, ``cuGraphNodeGetDependencies_v2``: CUDA
12.3 and later).  ``last_node_edges``: the incoming edges of the node the
capture added last.  The port's kernels that are launched over a
programmatic edge (``csrc/step_state.cuh::programmatic_edge``) are
checked with it: the edge is programmatic only where the capture kept it
so.  ``join_full``: the next node's one dependency an empty node after
the stream's, so that its edge is a full one whatever its launch asks."""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

#: CUgraphNodeType, by value
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "event_wait", 7: "event_record", 8: "semaphore_signal",
              9: "semaphore_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
              13: "conditional"}
_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE
_SET_DEPENDENCIES = 1  # CU_STREAM_SET_CAPTURE_DEPENDENCIES


class _EdgeData(ctypes.Structure):
    """CUgraphEdgeData: type 0 a full edge, 1 a programmatic one."""
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


@functools.lru_cache(maxsize=None)
def _driver():
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuStreamGetCaptureInfo_v3.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p)),
        ctypes.POINTER(ctypes.POINTER(_EdgeData)), ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetDependencies_v2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphAddEmptyNode.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t]
    cu.cuStreamUpdateCaptureDependencies.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t, ctypes.c_uint]
    return cu


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} failed: CUresult {status}")


def _capture_info(stream):
    """(status, graph, dependency nodes, their count) of ``stream``'s
    capture."""
    cu = _driver()
    status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
    deps, edges = ctypes.POINTER(ctypes.c_void_p)(), ctypes.POINTER(_EdgeData)()
    n = ctypes.c_size_t()
    _check(cu.cuStreamGetCaptureInfo_v3(ctypes.c_void_p(stream.cuda_stream),
                                        ctypes.byref(status), ctypes.byref(cid),
                                        ctypes.byref(graph), ctypes.byref(deps),
                                        ctypes.byref(edges), ctypes.byref(n)),
           "cuStreamGetCaptureInfo_v3")
    return status.value, graph, deps, n.value


def join_full() -> None:
    """While the current stream captures a graph, an empty node after the
    stream's dependencies becomes the one dependency of its next node: a
    programmatic edge holds only from a kernel node, so the edge into that
    node is a full one whatever its launch's attributes.  Where the
    dependencies lie on other cards this keeps a kernel launched over a
    programmatic edge from reading their writes on griddepcontrol.wait
    alone, which no CUDA document says orders another card's grid.
    Outside a capture nothing: a stream's wait on an event stays a full
    dependency (the attribute relaxes only the one on the previous kernel
    of the stream)."""
    if not torch.cuda.is_current_stream_capturing():
        return
    cu, stream = _driver(), torch.cuda.current_stream()
    status, graph, deps, n = _capture_info(stream)
    if status != _CAPTURE_ACTIVE:
        raise RuntimeError(f"the stream's capture is not active (status {status})")
    node = ctypes.c_void_p()
    _check(cu.cuGraphAddEmptyNode(ctypes.byref(node), graph, deps, n), "cuGraphAddEmptyNode")
    _check(cu.cuStreamUpdateCaptureDependencies(ctypes.c_void_p(stream.cuda_stream),
                                                ctypes.byref(node), 1, _SET_DEPENDENCIES),
           "cuStreamUpdateCaptureDependencies")


def last_node_edges(stream) -> List[Tuple[str, str, int]]:
    """The incoming edges of the one node the capture on ``stream`` (a
    ``torch.cuda.Stream``) added last: (the predecessor's node type,
    "programmatic" or "full", the edge's source port) each.  Raises when
    the stream is not capturing or its capture ends in other than one
    node."""
    cu = _driver()
    status, _, deps, n = _capture_info(stream)
    if status != _CAPTURE_ACTIVE or n != 1:
        raise RuntimeError(f"the stream is not capturing one last node (status "
                           f"{status}, {n} nodes)")
    node = ctypes.c_void_p(deps[0])
    k = ctypes.c_size_t()
    _check(cu.cuGraphNodeGetDependencies_v2(node, None, None, ctypes.byref(k)),
           "cuGraphNodeGetDependencies_v2")
    preds, data = (ctypes.c_void_p * k.value)(), (_EdgeData * k.value)()
    _check(cu.cuGraphNodeGetDependencies_v2(node, preds, data, ctypes.byref(k)),
           "cuGraphNodeGetDependencies_v2")
    out = []
    for p, e in zip(preds, data):
        t = ctypes.c_int()
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(p), ctypes.byref(t)), "cuGraphNodeGetType")
        out.append((NODE_TYPES.get(t.value, str(t.value)),
                    "programmatic" if e.type == 1 else "full", int(e.from_port)))
    return out
