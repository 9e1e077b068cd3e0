"""The port's device mesh over ``torch.distributed``.

The counterpart of ``repro.launch.mesh.make_mesh`` and
``repro.utils.compat.shard_map`` for the mesh substrate.  There a node
(or, on the virtual-node tier, a block of nodes) is a device of a JAX
mesh axis and its program runs inside ``shard_map``; here it is a rank
of an initialized ``torch.distributed`` process group, and every rank
runs the same program on its own node or block (SPMD).  :class:`NodeMesh`
gives that program the mesh axis's collectives: its index, ``ppermute``
over cyclic shifts (:meth:`NodeMesh.ppermute_many`, one tensor or a
tuple of them: a compressed payload, push-sum's pair), ``psum`` and
``all_gather``.

Transport.  A ``gloo`` group moves CPU tensors only, so on such a group
CUDA tensors are staged through host buffers (a copy to the host before
the send, back to the card after the receive), while the node's compute
stays on its device.  An ``nccl`` group passes CUDA tensors as they are.
The choice follows the group's backend and is reported as
:attr:`NodeMesh.transport`, never guessed.  :data:`TRANSPORT` adds up
the host seconds a rank spends in each half of its collectives, and
:data:`SENDS` its point-to-point sends.

:func:`spawn` starts one process per rank (``spawn`` start method, or
forks of the forkserver that :func:`warm_forkserver` started; a
``FileStore`` rendezvous in a temporary directory, no TCP port), runs a
function of an importable module on each, and returns every rank's
result, failing with the rank's traceback if one fails and with the
stacks of the ranks still running if the run outlasts its timeout.
"""
from __future__ import annotations

import collections
import datetime
import faulthandler
import multiprocessing.forkserver
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist


# Host seconds spent in this process's collectives, added by NodeMesh:
# "stage_s" the copies between the card and host memory (each copy to
# the host first waits for the work that produced the tensor), "wire_s"
# the backend's exchange itself.
TRANSPORT: collections.Counter = collections.Counter()
# Point-to-point sends of this process ("p2p"), one a leaf a shift of
# NodeMesh.ppermute_many: R·K·wire an outer iteration of a gossip
# program (the DispatchBudget's wire_mesh).
SENDS: collections.Counter = collections.Counter()
# spawn's start method where its caller names none: "forkserver" once
# warm_forkserver has started the server in this process
_start_method = "spawn"


class NodeMesh:
    """The mesh axis of a run: rank g of the default process group (or
    of ``group``) is node g, or on the virtual-node tier the g-th block
    of nodes, computing on ``device``.  Raises RuntimeError when no
    process group is initialized."""

    def __init__(self, device, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "the mesh substrate runs on every rank of an initialized "
                "torch.distributed process group (one rank per node); no "
                "process group is initialized in this process (see "
                "repro_torch.distributed.mesh.spawn)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        self._staged = self.device.type == "cuda" and self.backend != "nccl"

    @property
    def transport(self) -> str:
        """How a CUDA node's blocks cross the wire: ``"<backend>"`` when
        the backend moves device tensors (or the node computes on the
        CPU), ``"<backend>, staged through host memory"`` otherwise."""
        return (f"{self.backend}, staged through host memory"
                if self._staged else self.backend)

    def axis_index(self) -> int:
        """This rank's node index (``lax.axis_index`` of the axis)."""
        return self.rank

    # --------------------------------------------------------- transport

    def _out(self, t):
        t = t.contiguous()              # the backends send dense buffers
        if not self._staged:
            return t
        t0 = time.perf_counter()
        host = t.cpu()
        TRANSPORT["stage_s"] += time.perf_counter() - t0
        return host

    def _back(self, t):
        if not self._staged:
            return t
        t0 = time.perf_counter()
        dev = t.to(self.device)
        TRANSPORT["stage_s"] += time.perf_counter() - t0
        return dev

    @staticmethod
    def _timed(run):
        t0 = time.perf_counter()
        run()
        TRANSPORT["wire_s"] += time.perf_counter() - t0

    # ------------------------------------------------------- collectives

    def ppermute_many(self, z, shifts: Sequence[int]):
        """For each shift s, the block of node (g + s) mod L, received by
        every node g (``lax.ppermute`` with ``perm = [(i, (i − s) % L)]``),
        all in flight together in one ``batch_isend_irecv``, stacked: →
        (len(shifts), *z.shape).  ``z`` may be a tuple of tensors (a
        payload's leaves, each in its own dtype); then a tuple of such
        stacks comes back.  The message of shift k and leaf i carries tag
        k·(leaves) + i, so no two messages between the same pair of ranks
        can be confused.  A shift that is a multiple of L is the node's
        own block, copied without a message."""
        leaves = z if isinstance(z, tuple) else (z,)
        sends = [self._out(x) for x in leaves]
        recvs = [torch.empty((len(shifts),) + tuple(x.shape), dtype=x.dtype,
                             device=x.device) for x in sends]
        ops = []
        for k, s in enumerate(shifts):
            for i, (send, recv) in enumerate(zip(sends, recvs)):
                if s % self.size == 0:
                    recv[k].copy_(send)
                    continue
                tag = k * len(leaves) + i
                ops.append(dist.P2POp(dist.isend, send,
                                      (self.rank - s) % self.size,
                                      self.group, tag=tag))
                ops.append(dist.P2POp(dist.irecv, recv[k],
                                      (self.rank + s) % self.size,
                                      self.group, tag=tag))
        if ops:
            SENDS["p2p"] += len(ops) // 2
            self._timed(lambda: [req.wait()
                                 for req in dist.batch_isend_irecv(ops)])
        out = tuple(self._back(r) for r in recvs)
        return out if isinstance(z, tuple) else out[0]

    def psum(self, z):
        """The sum of every node's ``z`` (``lax.psum``), the same on
        every rank."""
        t = self._out(z).clone()
        self._timed(lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                            group=self.group))
        return self._back(t)

    def all_gather(self, z):
        """Every node's ``z`` stacked on a new leading node axis
        (``lax.all_gather``), the same on every rank."""
        t = self._out(z)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._timed(lambda: dist.all_gather(parts, t, group=self.group))
        return self._back(torch.stack(parts))


# ----------------------------------------------------------------------
# one process per rank
# ----------------------------------------------------------------------

def _rank_main(rank: int, world_size: int, store_path: str, backend: str,
               device: str, timeout: float, deadline: float, fn: Callable,
               args: tuple, results, stack_path: str) -> None:
    """A spawned rank: join the group, run ``fn(*args)``, report.
    ``deadline`` is the parent's, on the host's wall clock."""
    torch.set_num_threads(1)        # ranks share the host's cores
    with open(stack_path, "w") as stacks:
        # a rank still running just before the parent's deadline leaves
        # its stacks here, for the parent's error message
        margin = min(5.0, 0.1 * timeout)
        faulthandler.dump_traceback_later(
            max(1.0, deadline - margin - time.time()), file=stacks)
        try:
            if device == "cuda":
                torch.cuda.set_device(rank % torch.cuda.device_count())
            dist.init_process_group(
                backend, store=dist.FileStore(store_path, world_size),
                rank=rank, world_size=world_size,
                timeout=datetime.timedelta(seconds=timeout))
            try:
                out = fn(*args)
            finally:
                dist.destroy_process_group()
            results.put((rank, True, out))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
            raise
        finally:
            faulthandler.cancel_dump_traceback_later()


def warm_forkserver(preload: Sequence[str]) -> None:
    """Start the forkserver with the modules ``preload`` imported once
    (none may touch the card), and return at once: its imports overlap
    the caller's work.  From then on :func:`spawn`'s ranks fork from it
    unless the caller names a start method.  Once started, a later call
    changes nothing."""
    global _start_method
    multiprocessing.forkserver.set_forkserver_preload(list(preload))
    multiprocessing.forkserver.ensure_running()
    _start_method = "forkserver"


def spawn(fn: Callable, world_size: int, *, args: tuple = (),
          backend: str = "gloo", device: str = "cpu",
          timeout: float = 600.0, start_method: str | None = None) -> list:
    """Run ``fn(*args)`` on each of ``world_size`` fresh processes joined
    in one ``backend`` process group; return the results, rank by rank.

    ``fn`` must be importable by name (a module-level function), since
    each rank starts from a fresh interpreter (``start_method``
    ``"spawn"``, the default) or a fork of the forkserver
    (``"forkserver"``, the default once :func:`warm_forkserver` has run:
    its preloads must not touch the card); ``args``
    and the results are pickled.  With ``device="cuda"`` rank g computes
    on card g mod (number of cards).  The rendezvous is a ``FileStore`` in a
    temporary directory, so concurrent groups cannot collide.

    Raises RuntimeError with the rank's traceback as soon as one rank
    fails or exits without a result, and TimeoutError, with the stacks
    of the ranks still running, if the ranks have not all reported
    within ``timeout`` seconds.  Every rank is stopped before this
    returns or raises."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = torch.multiprocessing.get_context(start_method or _start_method)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        results = ctx.Queue()
        stacks = [os.path.join(tmp, f"stacks{g}.txt")
                  for g in range(world_size)]
        deadline = time.time() + timeout
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(g, world_size, os.path.join(tmp, "store"), backend, device,
                  timeout, deadline, fn, args, results, stacks[g]))
            for g in range(world_size)]
        for p in procs:
            p.start()
        out: dict = {}
        dead_seen = False
        try:
            while len(out) < world_size:
                left = deadline - time.time()
                if left <= 0:
                    raise TimeoutError(_timeout_message(
                        world_size, timeout, out, procs, stacks))
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [g for g, p in enumerate(procs)
                            if g not in out and p.exitcode not in (None, 0)]
                    if dead and dead_seen:   # its report, if any, is read
                        raise RuntimeError(
                            f"mesh rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a "
                            f"result") from None
                    dead_seen = bool(dead)
                    continue
                if not ok:
                    raise RuntimeError(f"mesh rank {rank} failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(timeout=60)
            bad = {g: p.exitcode for g, p in enumerate(procs)
                   if p.exitcode != 0}
            if bad:
                raise RuntimeError(f"mesh ranks exited with codes {bad} "
                                   f"after reporting their results")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
            results.close()
            results.join_thread()
    return [out[g] for g in range(world_size)]


def _timeout_message(world_size, timeout, out, procs, stacks) -> str:
    waiting = [g for g in range(world_size) if g not in out]
    lines = [f"mesh ranks {waiting} of {world_size} did not report within "
             f"{timeout:g} s"]
    for g in waiting:
        procs[g].kill()
        procs[g].join(timeout=30)
        try:
            with open(stacks[g]) as f:
                dump = f.read().strip()
        except OSError:
            dump = ""
        lines.append(f"--- rank {g} stacks ---\n{dump or '(none written)'}")
    return "\n".join(lines)
