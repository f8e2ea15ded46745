"""Data parallelism over ``torch.distributed`` (``mickey_tpu/parallel.py``'s
1-D data mesh).

The JAX package shards each batch on the ``data`` axis of a mesh and lets
the partitioner make every batch reduction global. Here each rank is one
process on one device, holds a full copy of the trainable state and runs its
contiguous rows of each padded global batch; the reductions the partitioner
inserts are explicit:

- train-mode BatchNorm (``nn/common.batchnorm``) all-reduces its sums and
  sums of squares, with gradients (``all_reduce_sum``), and counts the
  global batch in its running variance;
- the loss (``training/loss.py``) gathers the pairs' baselines for the
  curriculum threshold, divides by the global sum of the mask and reports
  global means and sums;
- the random draws of training and validation (``ops/sampling.gumbel_noise``)
  are the global batch's, from the one generator every rank holds, of which
  each rank keeps its rows;
- the gradients are summed over the ranks (each rank's loss is its share of
  the global loss), in one flat buffer (``DataParallel.all_reduce_``).

So N ranks compute the one-device step on the global batch, up to the order
of the sums. These reductions act only inside ``global_batch(dp, rows)``,
which the trainer enters around its steps; with no process group, or at one
rank, it does nothing and every path computes exactly what it computes
without this module. Serving needs none of them: each rank solves its own
pairs with a generator folded with its rank (``DataParallel.fold``), the
counterpart of ``fold_in(key, axis_index)``.

Setup: ``init_data_parallel`` (torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK``; NCCL on ``cuda:LOCAL_RANK`` where there is a card, gloo on
the CPU) or ``launch(fn, world)``, which builds the native libraries once
and spawns ``world`` ranks (NCCL, a card a rank, where there are cards) in
fresh processes that import only torch, the port and ``fn``'s module.

Tensor parallelism (``get_mesh_2d``, ``vit_tp_shardings``,
``shard_backbone``): ``init_grid(tp)`` splits the world into a (data,
model) grid as JAX's ``reshape(dp, tp)`` of the devices does. Global rank r
is data index r // tp and model index r % tp, so a model group is tp
consecutive ranks and a data group every tp-th rank. ``world()`` is then
the rank's data group, whose collectives (BatchNorm's sums, the loss's
reductions, the gradient sum) run on that group alone: the tp ranks of a
model group hold the same rows, and a sum over the world would count them
tp times. ``tensor_parallel()`` is the rank's ``TensorParallel``. The
frozen DINOv2 is Megatron-sharded over it (``shard_backbone``, the dims in
``vit_tp_split``): each rank keeps its column shard of qkv and fc1 (whole
heads: the qkv columns are head-major) and its row shard of proj and fc2,
and ``nn/dinov2.block_apply`` sums the row-parallel partials over the model
group before adding the bias. The trainable heads and matcher stay
replicated. Without a grid nothing of this acts.
"""

from __future__ import annotations

import contextvars
import datetime
import hashlib
import os
import queue
import tempfile
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataParallel:
    """One rank of a process group, on either axis of the grid: ``rank`` of
    ``size`` processes, this rank's ``device``, the process ``group`` (None:
    the default one, the whole world). ``size == 1`` is the single process,
    in which every collective below is the identity."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n`` (a multiple
        of ``size``)."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} does not split over {self.size} ranks: pad it first")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_rows(self, x):
        """This rank's rows of a padded global batch (a tensor or an array)."""
        return x[self.rows(x.shape[0])]

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of equal shape, in rank order: the global batch."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def all_gather_objects(self, obj) -> List[Any]:
        """Every rank's ``obj`` (picklable), in rank order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a tensor that carries no gradient."""
        if self.size == 1:
            return x
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ranks, in place, through one flat buffer
        per dtype (the gradient leaves: one collective, not one a leaf)."""
        if self.size == 1:
            return
        for same in _by_dtype(tensors).values():
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.all_reduce(flat, group=self.group)
            _unflatten_into(flat, same)

    def all_reduce_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks in place, in its own dtype and without
        autograd (the row-parallel partials of the frozen backbone); returns
        ``x``."""
        if self.size > 1:
            with torch.no_grad():
                dist.all_reduce(x, group=self.group)
        return x

    def _src(self) -> int:
        """The global rank of the group's rank 0."""
        return 0 if self.group is None else dist.get_global_rank(self.group, 0)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite each tensor with rank 0's, in place, through one flat
        buffer per dtype."""
        if self.size == 1:
            return
        for same in _by_dtype(tensors).values():
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src=self._src(), group=self.group)
            _unflatten_into(flat, same)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self._src(), group=self.group)
        return box[0]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group, device_ids=[self.device.index] if _backend() == "nccl" else None)

    def fold(self, generator: torch.Generator) -> torch.Generator:
        """A generator on ``generator``'s device seeded from its state and
        this rank: each rank's serving draws independent of the others', the
        counterpart of ``jax.random.fold_in(key, axis_index)``."""
        state = generator.get_state().numpy().tobytes()
        seed = int.from_bytes(hashlib.sha256(state + self.rank.to_bytes(4, "little")).digest()[:8], "little")
        return torch.Generator(device=generator.device).manual_seed(seed & ((1 << 63) - 1))


# One rank of a model (tensor-parallel) group: the ranks that hold the same
# rows and split the frozen backbone's block linears (``shard_backbone``),
# whose one collective is ``all_reduce_sum_``. ``size == 1`` is no tensor
# parallelism.
TensorParallel = DataParallel


def _by_dtype(tensors) -> Dict[torch.dtype, List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _unflatten_into(flat: torch.Tensor, group: Sequence[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _backend() -> Optional[str]:
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def world() -> DataParallel:
    """This process's data-parallel group: its data group where
    ``init_grid`` made a grid, else its place in the default process group,
    or the single process where there is none."""
    if _backend() is None:
        return DataParallel()
    if _grid is not None:
        return _grid[0]
    return DataParallel(dist.get_rank(), dist.get_world_size(), _device)


def tensor_parallel() -> TensorParallel:
    """This process's model group where ``init_grid`` made a grid, else no
    tensor parallelism."""
    return _grid[1] if _backend() is not None and _grid is not None else TensorParallel()


# the device init_data_parallel chose for this process's rank, and the grid
# init_grid made (the process group it joined is process-wide too)
_device = torch.device("cpu")
_grid: Optional[Tuple[DataParallel, TensorParallel]] = None


def init_data_parallel(backend: Optional[str] = None, device=None, init_method: str = "env://",
                       rank: Optional[int] = None, world_size: Optional[int] = None,
                       timeout_s: float = 1800.0) -> DataParallel:
    """Join the default process group and return this rank.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``. ``backend`` defaults to NCCL where there is a card (or
    ``device`` is one) and gloo where there is none (or ``device`` is the
    CPU); ``device`` to ``cuda:LOCAL_RANK`` under NCCL and the CPU under
    gloo. Gloo on a card
    (``backend="gloo", device="cuda:0"``) carries CUDA tensors through the
    host: two ranks on one card, which NCCL refuses. Raises where the asked
    backend is not built into this PyTorch or has no device to run on."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend is None:
        on_card = torch.device(device).type == "cuda" if device is not None else torch.cuda.is_available()
        backend = "nccl" if on_card else "gloo"
    available = {"nccl": dist.is_available() and dist.is_nccl_available(),
                 "gloo": dist.is_available() and dist.is_gloo_available()}
    if not available.get(backend, False):
        raise RuntimeError(f"the {backend} backend is not available in this PyTorch build")
    if device is None:
        device = f"cuda:{local_rank}" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} asks for {device} and this machine has "
                               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA devices")
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise RuntimeError("NCCL runs on CUDA devices only")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    global _device
    _device = device
    return world()


def init_grid(tp: int, **join) -> Tuple[DataParallel, TensorParallel]:
    """Split the world into a (data, model) grid of ``world // tp`` data
    groups of ``tp`` ranks (``mickey_tpu``'s ``get_mesh_2d(tp)``): global
    rank r is data index r // tp and model index r % tp. Joins the default
    group first where this process has none (``join`` as
    ``init_data_parallel``'s arguments). Every rank creates every group, in
    one order, as ``torch.distributed.new_group`` requires. Returns this
    rank's (data group, model group), which ``world()`` and
    ``tensor_parallel()`` return from then on."""
    global _grid
    if _backend() is None:
        init_data_parallel(**join)
    size, rank = dist.get_world_size(), dist.get_rank()
    if tp < 1 or size % tp:
        raise ValueError(f"{size} ranks not divisible by tp={tp}")
    dp = size // tp
    data_groups = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
    model_groups = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
    d, m = divmod(rank, tp)
    _grid = (DataParallel(d, dp, _device, data_groups[m]), TensorParallel(m, tp, _device, model_groups[d]))
    return _grid


def refuse_cpu_group(dp: DataParallel, asked_cpu: bool) -> None:
    """Raise where ``dp``'s group runs on the CPU of a machine with CUDA
    devices and the caller did not ask for the CPU: an entry point never
    falls back to the CPU behind its caller's back."""
    if dp.device.type == "cpu" and torch.cuda.is_available() and not asked_cpu:
        raise RuntimeError(f"rank {dp.rank} of {dp.size} joined its group on the CPU on a machine with "
                           f"{torch.cuda.device_count()} CUDA devices: join on the cards (NCCL, the default of "
                           "init_data_parallel and launch), or ask for the CPU")


def close_data_parallel() -> None:
    """Leave the default process group and every group of the grid."""
    global _grid
    _grid = None
    if _backend() is not None:
        dist.destroy_process_group()


def pad_batch(tree: Dict[str, np.ndarray], multiple: int):
    """Pad the leading dim of every array to a multiple (repeat the last
    element); returns (padded_tree, real_batch). ``mickey_tpu``'s."""
    b = next(iter(tree.values())).shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return tree, b
    out = {}
    for k, v in tree.items():
        v = np.asarray(v)
        out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
    return out, b


def shard_indices(idxs: Sequence[int], rank: int, size: int) -> List[int]:
    """Rank ``rank``'s rows of a batch of dataset indices padded as
    ``pad_batch`` pads the loaded arrays (the last index repeated)."""
    idxs = list(idxs)
    idxs += idxs[-1:] * ((-len(idxs)) % size)
    per = len(idxs) // size
    return idxs[rank * per:(rank + 1) * per]


# -- the batch-global reductions of a step ----------------------------------------------


class GlobalBatch(NamedTuple):
    """The step in flight: this rank's rows [lo, hi) of a global batch of
    ``size`` pairs."""

    dp: DataParallel
    size: int
    lo: int
    hi: int


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mickey_global_batch", default=None)


@contextmanager
def global_batch(dp: DataParallel, rows: int):
    """Make BatchNorm, the loss and the draws of the enclosed code act on the
    global batch whose rows ``rows`` pairs a rank holds. Does nothing at one
    rank."""
    if dp.size == 1:
        yield
        return
    token = _ACTIVE.set(GlobalBatch(dp, rows * dp.size, dp.rank * rows, (dp.rank + 1) * rows))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[GlobalBatch]:
    """The global batch of the step in flight, or None (one rank, or outside
    a step)."""
    return _ACTIVE.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks whose backward sums the cotangents over
    them: every rank's loss depends on every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The sum of ``x`` over ``dp``'s ranks, with gradients (BatchNorm's sums)."""
    return x if dp.size == 1 else _AllReduceSum.apply(x, dp.group)


# -- launching ranks ---------------------------------------------------------------------


def _child(rank: int, world_size: int, backend: Optional[str], device, init_file: str, fn: Callable, args: tuple,
           results, tp: int = 1) -> None:
    """A spawned rank: join the group (and the grid where ``tp`` > 1), run
    ``fn(*args)``, hand its result (or its traceback) to the parent."""
    try:
        os.environ["LOCAL_RANK"] = str(rank)  # one host: the backend's default device is cuda:rank
        dp = init_data_parallel(backend, device, init_method=f"file://{init_file}", rank=rank,
                                world_size=world_size, timeout_s=300.0)
        if dp.device.type == "cpu":
            torch.set_num_threads(1)  # ranks share the host's cores
        if tp > 1:
            init_grid(tp)
        # every rank joined before any runs fn: a rank that returned and left the group at once
        # would otherwise break the connection a slower peer was still making
        DataParallel(rank, world_size, dp.device).barrier()
        try:
            out = fn(*args)
        finally:
            close_data_parallel()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def build_libraries(cuda: bool) -> None:
    """Build (where not yet built) and load the port's native libraries in
    this process: the JPEG ingest, and the CUDA kernels where ``cuda``.
    Ranks that start together would otherwise each compile them."""
    from .data import native

    native.ensure_built()
    if cuda:
        from .ops import _cuda

        _cuda.build()


def build_libraries_once(dp: DataParallel) -> None:
    """``build_libraries`` on rank 0 while the other ranks wait, for ranks
    that ``torch.distributed.run`` started: they then load its build."""
    if dp.rank == 0:
        build_libraries(dp.device.type == "cuda")
    dp.barrier()


def launch(fn: Callable, world_size: int, backend: Optional[str] = None, device=None, args: tuple = (),
           timeout_s: float = 600.0, tp: int = 1) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a fresh process
    (``spawn``) in one process group; returns their results in rank order.

    ``fn`` travels by its import path: it must be a module-level function of
    a module that the children can import (the port, or a module that
    imports only torch and the port). ``backend`` and ``device`` as in
    ``init_data_parallel``, rank r's default device ``cuda:r``: by default
    NCCL, a card a rank, where there are cards (more ranks than cards
    raise), and gloo on the CPU where there are none. ``backend="gloo"``
    runs the ranks on the CPU, or with a ``cuda:i`` ``device`` all on that
    one card. The native libraries are built here, once, before the ranks
    start. With ``tp`` > 1 each rank also makes the (data, model) grid
    (``init_grid(tp)``) before it calls ``fn``. Raises with the rank's
    traceback if a rank fails; a rank still running after ``timeout_s`` is
    killed, with its peers, and the launch raises."""
    import torch.multiprocessing as mp

    if tp < 1 or world_size % tp:
        raise ValueError(f"{world_size} ranks not divisible by tp={tp}")
    on_cards = (torch.device(device).type == "cuda" if device is not None
                else backend == "nccl" or (backend is None and torch.cuda.is_available()))
    build_libraries(on_cards)

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mickey_dp_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child, args=(r, world_size, backend, device, init_file, fn, args, results, tp),
                             daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        failures: Dict[int, str] = {}
        try:
            deadline = time.monotonic() + timeout_s
            seen_dead: set = set()
            while len(got) + len(failures) < world_size:
                left = deadline - time.monotonic()
                try:
                    rank, ok, out = results.get(timeout=min(max(left, 0.1), 1.0))
                except queue.Empty:
                    # a rank that exited without a result, seen so on two polls in a row (its
                    # last words may still have been on their way at the first)
                    dead = {r for r, p in enumerate(procs) if not p.is_alive() and r not in got and r not in failures}
                    if left <= 0 or dead & seen_dead:
                        missing = sorted(set(range(world_size)) - set(got) - set(failures))
                        failures.update({r: f"no result within {timeout_s:.0f} s"
                                         + (" (exited)" if r in dead else "") for r in missing})
                    seen_dead = dead
                    continue
                if ok:
                    got[rank] = out
                else:  # the others may fail because of it: give them a moment to say so
                    failures[rank] = out
                    deadline = min(deadline, time.monotonic() + 10.0)
            if failures:
                raise RuntimeError("data-parallel launch failed:\n" + "\n".join(
                    f"rank {r} failed:\n{tb}" for r, tb in sorted(failures.items())))
        finally:  # a failed launch kills its ranks at once; a done one gives them time to exit
            for p in procs:
                p.join(timeout=0.1 if failures or len(got) < world_size else 10.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    return [got[r] for r in range(world_size)]


# -- the tensor-parallel backbone --------------------------------------------------------

# the port's block linears are (out, in): a column-parallel linear splits its
# output rows (dim 0) and its bias, a row-parallel one its input columns
# (dim 1) and keeps its bias whole
_TP_DIMS = {"qkv": {"w": 0, "b": 0}, "proj": {"w": 1, "b": None}, "fc1": {"w": 0, "b": 0},
            "fc2": {"w": 1, "b": None}}


def vit_tp_split(backbone):
    """The dim on which each leaf of the port's backbone tree is split over
    the model group (None: kept whole), a tree of its structure
    (``vit_tp_shardings``): qkv and fc1 weights and biases on dim 0, proj and
    fc2 weights on dim 1 with their biases whole; LayerNorms, LayerScale,
    the embeddings and SwiGLU's ``w12`` / ``w3`` whole."""

    def walk(node, dims):
        if isinstance(node, dict):
            dims = dims if isinstance(dims, dict) else {}
            return {k: walk(v, dims.get(k)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, dims) for v in node]
        return dims if isinstance(dims, int) else None

    return walk(backbone, {"blocks": {"attn": _TP_DIMS, "mlp": _TP_DIMS}})


def shard_backbone(tp: Optional[TensorParallel], backbone, num_heads: int):
    """This rank's tree of the frozen backbone under ``tp`` (``mickey_tpu``'s
    ``shard_backbone``): every split leaf (``vit_tp_split``) replaced by a
    contiguous copy of its ``tp.rank``-th of ``tp.size`` slices, so that its
    storage shrinks by the factor; the whole leaves shared. The qkv rows are
    head-major (``ops/flash_attention.py``), so a slice is whole heads.
    ``backbone`` itself is left as it was. With no tensor parallelism it is
    returned. Raises ValueError where ``tp.size`` does not divide
    ``num_heads`` and on an int8 tree, whose quantized leaves no split
    covers."""
    if tp is None or tp.size == 1:
        return backbone
    if any("w_q" in lin for bp in backbone["blocks"] for part in ("attn", "mlp") for lin in bp[part].values()):
        raise ValueError("tensor parallelism does not split an int8 backbone (MICKEY.DINOV2.INT8): shard the "
                         "unquantized tree")
    if num_heads % tp.size:
        raise ValueError(f"tensor-parallel size {tp.size} must divide num_heads={num_heads}")

    def cut(t, dim):
        if dim is None:
            return t
        n = t.shape[dim] // tp.size
        return t.narrow(dim, tp.rank * n, n).clone(memory_format=torch.contiguous_format)

    def walk(node, dims):
        if isinstance(node, dict):
            return {k: walk(v, dims[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, d) for v, d in zip(node, dims)]
        return cut(node, dims)

    with torch.no_grad():
        return walk(backbone, vit_tp_split(backbone))


def data_parallel_steps(cfg, batch: Dict, steps: int = 1, seed: int = 0, sample_override=None, params=None,
                        device="cuda", tp: Optional[TensorParallel] = None) -> Dict:
    """``steps`` staged steps of a ``MicKeyTrainer`` on one global ``batch``
    (arrays whose pairs split evenly over the ranks) in this process's
    data-parallel group, each rank on its rows: the entry ``launch`` runs on
    each rank to hold N ranks against one process, which calls it alone
    (``chip_smoke.py --ddp``). The loss draws are the rows of the global
    ``sample_override`` (idx, ridx), or the trainer's generator's. ``tp``:
    the model group whose ranks split the backbone (by default this
    process's, ``tensor_parallel()``; the rows are the data group's). Under
    a group of N > 1 ranks the model runs on the rank's device, else on
    ``device``. Returns the trainables and Adam's moments after the first
    step (``first``) and the trainables after the last (numpy trees,
    ``mickey_tpu``'s layout), each step's metrics, its seconds on the host
    clock (the device synchronized) and the kernels launched."""
    from .models.training_model import MicKeyTrainer
    from .ops import _cuda
    from .weights import params_to_numpy

    before = dict(_cuda.LAUNCHES)
    dp = world()
    tp = tensor_parallel() if tp is None else tp
    grouped = dp.size > 1 or tp.size > 1
    tr = MicKeyTrainer(cfg, params=params, seed=seed, device=dp.device if grouped else device, dp=dp, tp=tp)
    rows = dp.rows(len(batch["T_0to1"]))
    local = {k: torch.as_tensor(v)[rows] for k, v in batch.items()}
    override = None if sample_override is None else tuple(torch.as_tensor(x)[rows].to(tr.device)
                                                          for x in sample_override)
    metrics, seconds, first = [], [], None
    for _ in range(steps):
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        t0 = time.perf_counter()
        with global_batch(dp, len(local["T_0to1"])):
            _, m = tr.train_step(tr.state, tr.backbone, tr.device_batch(local), tr.generator, tr.topk,
                                 sample_override=override)
        metrics.append({k: float(v) for k, v in m.items()})
        seconds.append(time.perf_counter() - t0)
        if first is None:
            opt = tr.state.opt_state
            first = {"params": params_to_numpy(tr.state.params), "mu": tr._moments(opt.mu), "nu": tr._moments(opt.nu)}
    return {"first": first, "params": params_to_numpy(tr.state.params), "metrics": metrics, "seconds": seconds,
            "launches": {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}}
