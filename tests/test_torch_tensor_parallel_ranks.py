"""What each rank runs in ``tests/test_torch_tensor_parallel.py``'s checks of
the tensor-parallel backbone (``parallel.launch(..., tp=...)``).

``launch`` spawns fresh processes that import the function's module, so this
module imports only numpy, torch, the port, ``chip_smoke`` and the port-only
rank helpers of ``tests/test_torch_parallel_ranks.py``: never jax nor
``mickey_tpu``. It holds no tests.
"""

from __future__ import annotations

from pathlib import Path

import chip_smoke
from mickey_tpu_torch.nn import dinov2
from mickey_tpu_torch.weights import params_to_numpy
from test_torch_parallel_ranks import injected_draws


def rank_features_with_bias_on_every_rank(*args, **kwargs):
    """``chip_smoke.tensor_parallel_features`` with a wrong row-parallel
    linear: every rank adds the whole bias to its partial sum, so the group's
    sum holds it tp times."""
    import torch.nn.functional as F

    def wrong(p, x, tp):
        if dinov2._tp_size(tp) == 1:
            return dinov2.maybe_linear(p, x)
        return tp.all_reduce_sum_(F.linear(x, p["w"].to(x.dtype), p["b"].to(x.dtype)))

    dinov2.row_parallel_linear = wrong
    return chip_smoke.tensor_parallel_features(*args, **kwargs)


def rank_grid():
    """This rank's places: (global rank, data rank and size, model rank and
    size)."""
    import torch.distributed as dist

    from mickey_tpu_torch import parallel

    dp, tp = parallel.world(), parallel.tensor_parallel()
    return dist.get_rank(), (dp.rank, dp.size), (tp.rank, tp.size)


def rank_fits(runs, params, draws=None):
    """``rank_fit_writes`` for each (cfg, out_dir) of ``runs`` in turn."""
    return [rank_fit_writes(cfg, params, out_dir, draws) for cfg, out_dir in runs]


def rank_fit_writes(cfg, params, out_dir: str, draws=None):
    """One epoch of ``MicKeyTrainer.fit`` on this rank of the process's grid
    (or alone), the loss draws injected (``injected_draws``): the trainables,
    Adam's first moments, the checkpoints this rank wrote, whether it has a
    log writer, the fingerprint it holds the feature cache to, and the bytes
    behind its backbone's split leaves."""
    from mickey_tpu_torch.data.loader import DataModuleTraining
    from mickey_tpu_torch.models import MicKeyTrainer, training_model

    saved = []
    save = training_model.save_checkpoint
    training_model.save_checkpoint = lambda path, *a, **k: (saved.append(Path(path).name), save(path, *a, **k))
    try:
        tr = MicKeyTrainer(cfg, params=params, device="cpu", out_dir=out_dir)
        with injected_draws(draws):
            tr.fit(DataModuleTraining(cfg), max_epochs=1, val_batches=1, log_interval=10)
    finally:
        training_model.save_checkpoint = save
    return {"params": params_to_numpy(tr.state.params), "mu": tr._moments(tr.state.opt_state.mu), "saved": saved,
            "writer": bool(tr._get_writer()), "fingerprint": tr._fingerprint, "main": tr.main,
            "split_bytes": chip_smoke.split_bytes(tr.backbone),
            "tp": (tr.tp.rank, tr.tp.size), "dp": (tr.dp.rank, tr.dp.size)}
