"""Two-way bridge between ``mickey_tpu``'s orbax checkpoints and the PyTorch
port's native ones (``mickey_tpu_torch/training/checkpoint.py``).

``mickey_tpu``'s trainer writes orbax directories (``best_vcre/``,
``best_pose/``, ``last/``); the port writes one ``checkpoint.pt`` in the
same parameter layout. This tool maps one onto the other, so a model trained
by either package is served or resumed by the other:

    python tools/checkpoint_bridge_torch.py to-native <orbax_dir> <out_dir> [--config a.yaml [b.yaml ...]]
    python tools/checkpoint_bridge_torch.py from-native <native_dir> <out_dir> --config [a.yaml ...]

``--config`` takes the YAML overlays of the run that wrote the checkpoint,
applied in order to the default config (none: the defaults). The trainables
must have the layout that the config gives ``mickey_tpu``'s trainer
(``model_init(key, cfg, include_backbone=False)``); a mismatch is refused
and names the first leaf that differs.

The optimizer state is ``mickey_tpu``'s
``apply_if_finite(chain([clip_by_global_norm,] adam(schedule)))``. The
native format keeps Adam's ``count``, ``mu`` and ``nu``; the schedule's
count must equal Adam's (both advance only on applied steps, and the port's
learning-rate staircase reads Adam's). ``apply_if_finite``'s own counters
have no place in the port's state: ``to-native`` prints and drops them,
``from-native`` leaves them at their initial values. BatchNorm statistics
carry the moments stored beside them (zeros in both formats), copied as
they are. ``extra`` (``topk``, ``epoch``) is copied as it is; the packages
differ in what they do with ``epoch`` on resume: ``mickey_tpu`` starts the
saved epoch over, the port goes on with the next one.

``from-native`` writes what ``mickey_tpu`` reads from each kind of
directory: a ``last/`` (with optimizer state) as its ``MicKeyTrainer.resume``
reads it (params, opt_state, step, extra); a directory without optimizer
state (``best_vcre/``, ``best_pose/``) as its ``build_model(checkpoint=...)``
reads it, params and step only: that function restores against the target
{params, step}, and orbax refuses a directory that holds more items.

The tool runs where ``jax``, ``orbax`` and ``optax`` are installed, on one
host (orbax's restore without a target is single-host only), never on the
card's machine, and on the CPU. Neither package imports it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ADAM_FIELDS = ("count", "mu", "nu")  # optax.ScaleByAdamState
SCHEDULE_FIELDS = ("count",)  # optax.ScaleByScheduleState
FINITE_FIELDS = ("notfinite_count", "last_finite", "total_notfinite")  # optax.ApplyIfFiniteState's counters


def trainable_layout(cfg) -> dict:
    """The trainables' tree that ``cfg`` gives ``mickey_tpu``'s trainer:
    ``model_init(key, cfg, include_backbone=False)``'s shapes and dtypes
    (``jax.eval_shape``: nothing is drawn) as zero numpy arrays, the 0-d
    dustbin too, as orbax takes a target."""
    import jax

    from mickey_tpu.nn.extractor import model_init

    shapes = jax.eval_shape(lambda k: model_init(k, cfg, include_backbone=False), jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _plain(node):
    """An optax state (NamedTuples, tuples) or orbax's restore of one without
    a target (dicts, lists) -> nested dicts and lists."""
    if hasattr(node, "_fields"):
        return {f: _plain(getattr(node, f)) for f in node._fields}
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def _leaf_shapes(tree, path="") -> dict:
    """{"a/b/0/c": shape} of a nested tree's array leaves (None and empty
    nodes hold none; orbax metadata leaves carry ``shape``)."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _leaf_shapes(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: s for i, v in enumerate(tree) for p, s in _leaf_shapes(v, f"{path}/{i}").items()}
    return {} if tree is None else {path: tuple(getattr(tree, "shape", np.shape(tree)))}


def check_layout(got, want, what: str) -> None:
    """Raise ``ValueError`` naming the first leaf (in sorted path order) where
    the trees ``got`` and ``want`` differ in presence or shape."""
    g, w = _leaf_shapes(_plain(got), what), _leaf_shapes(_plain(want), what)
    for path in sorted(set(g) | set(w)):
        if g.get(path) != w.get(path):
            side = ("only in the checkpoint" if path not in w else "missing from the checkpoint" if path not in g
                    else f"shape {g[path]} in the checkpoint, {w[path]} expected")
            raise ValueError(f"{path}: {side}")


def _find(tree, fields, path=""):
    """[(path, node)] of every dict of a plain tree whose keys are ``fields``."""
    if isinstance(tree, dict):
        if set(tree) == set(fields):
            return [(path or "/", tree)]
        return [hit for k, v in tree.items() for hit in _find(v, fields, f"{path}/{k}")]
    if isinstance(tree, list):
        return [hit for i, v in enumerate(tree) for hit in _find(v, fields, f"{path}/{i}")]
    return []


def _numpy(tree):
    """Leaves -> numpy arrays (copies); None and the nesting kept."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return None if tree is None else np.array(tree, copy=True)


def native_opt_state(opt_state, params) -> tuple:
    """``mickey_tpu``'s optimizer state (either form) -> (the native
    {"count", "mu", "nu"}, {the apply_if_finite counters found}). The Adam
    state is found by its fields; raises where there is not exactly one,
    where a schedule's count differs from Adam's, or where a moment's layout
    differs from the params'."""
    opt = _plain(opt_state)
    adams = _find(opt, ADAM_FIELDS)
    if len(adams) != 1:
        raise ValueError(f"opt_state: {len(adams)} Adam states (fields {', '.join(ADAM_FIELDS)}) at "
                         f"{[p for p, _ in adams]}; the native format holds exactly one")
    path, adam = adams[0]
    count = int(np.asarray(adam["count"]))
    for spath, sched in _find(opt, SCHEDULE_FIELDS):
        if int(np.asarray(sched["count"])) != count:
            raise ValueError(f"opt_state{spath}/count: the schedule's count {int(np.asarray(sched['count']))} != "
                             f"Adam's count {count} (opt_state{path}/count); the port's learning rate reads Adam's")
    for name in ("mu", "nu"):
        check_layout(adam[name], params, f"opt_state{path}/{name}")
    dropped = {f: np.asarray(opt[f]).item() for f in FINITE_FIELDS if isinstance(opt, dict) and f in opt}
    return {"count": count, "mu": _numpy(adam["mu"]), "nu": _numpy(adam["nu"])}, dropped


def optax_opt_state(template, count: int, mu, nu):
    """``template`` (``make_optimizer(cfg).init(params)``) with its Adam
    state's count and moments and its schedules' counts replaced; every other
    field (``apply_if_finite``'s counters) kept."""
    import jax

    def is_state(x):
        return getattr(x, "_fields", None) in (ADAM_FIELDS, SCHEDULE_FIELDS)

    def put(x):
        if not is_state(x):
            return x
        c = np.asarray(count, dtype=np.asarray(x.count).dtype)
        return x._replace(count=c, mu=mu, nu=nu) if x._fields == ADAM_FIELDS else x._replace(count=c)

    return jax.tree.map(put, template, is_leaf=is_state)


def _orbax_items(path: str) -> dict:
    """The top-level items of an orbax checkpoint -> their metadata trees."""
    import orbax.checkpoint as ocp

    meta = ocp.StandardCheckpointer().metadata(os.path.abspath(path)).item_metadata
    return {k: meta[k] for k in meta.keys()}


def _python(v):
    return v.item() if hasattr(v, "item") else v


def to_native(orbax_dir: str, out_dir: str, cfg=None) -> dict:
    """Convert ``mickey_tpu``'s orbax directory into a native one; returns a
    summary (step, count, extra, the dropped ``apply_if_finite`` counters).
    With ``cfg`` the params are checked against its layout first and the
    restore takes a target built from it; without, orbax restores without
    a target."""
    from mickey_tpu.training.checkpoint import restore_checkpoint as restore_orbax
    from mickey_tpu_torch.training.checkpoint import save_checkpoint as save_native

    items = _orbax_items(orbax_dir)
    if "params" not in items:
        raise ValueError(f"{orbax_dir}: no params item (items: {sorted(items)})")
    if cfg is None:
        restored = restore_orbax(orbax_dir)
    else:
        from mickey_tpu.training.train_step import make_optimizer

        layout = trainable_layout(cfg)
        check_layout(items["params"], layout, "params")
        like = {"params": layout, "step": 0}
        if "opt_state" in items:
            like["opt_state"] = make_optimizer(cfg).init(layout)
            check_layout(items["opt_state"], like["opt_state"], "opt_state")
        if "extra" in items:
            like["extra"] = {k: {"b": False, "i": 0, "u": 0}.get(np.dtype(m.dtype).kind, 0.0)
                             for k, m in items["extra"].items()}
        restored = restore_orbax(orbax_dir, like=like)
    params = _numpy(restored["params"])
    opt_state, dropped = (None, {})
    if "opt_state" in restored:
        opt_state, dropped = native_opt_state(restored["opt_state"], params)
    extra = {k: _python(v) for k, v in restored["extra"].items()} if "extra" in restored else None
    step = int(_python(restored["step"]))
    save_native(out_dir, params, step=step, opt_state=opt_state, extra=extra)
    return {"step": step, "count": None if opt_state is None else opt_state["count"], "extra": extra,
            "dropped": dropped}


def from_native(native_dir: str, out_dir: str, cfg) -> dict:
    """Convert a native directory into ``mickey_tpu``'s orbax format (module
    docstring: a ``last/`` whole, one without optimizer state as params and
    step); returns a summary (step, count, the items written)."""
    from mickey_tpu.training.checkpoint import save_checkpoint as save_orbax
    from mickey_tpu.training.train_step import make_optimizer
    from mickey_tpu_torch.training.checkpoint import restore_checkpoint as restore_native

    ck = restore_native(native_dir)
    params = ck["params"]
    check_layout(params, trainable_layout(cfg), "params")
    opt_state, extra = None, None
    if "opt_state" in ck:
        o = ck["opt_state"]
        for name in ("mu", "nu"):
            check_layout(o[name], params, f"opt_state/{name}")
        opt_state = optax_opt_state(make_optimizer(cfg).init(params), o["count"], o["mu"], o["nu"])
        extra = ck["extra"] or None
    save_orbax(out_dir, params, step=ck["step"], opt_state=opt_state, extra=extra)
    items = ["params", "step"] + (["opt_state"] if opt_state is not None else []) + (["extra"] if extra else [])
    return {"step": ck["step"], "count": None if opt_state is None else ck["opt_state"]["count"], "items": items}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("direction", choices=("to-native", "from-native"))
    ap.add_argument("src", help="the checkpoint directory to read")
    ap.add_argument("out", help="the directory to write")
    ap.add_argument("--config", nargs="*", default=None,
                    help="YAML overlays of the run, in order (given without files: the default config); "
                         "required by from-native")
    args = ap.parse_args(argv)
    if args.direction == "from-native" and args.config is None:
        ap.error("from-native needs --config: the optimizer state is built from the config's optimizer")

    import jax

    from mickey_tpu.config import load_config

    jax.config.update("jax_platforms", "cpu")
    cfg = None if args.config is None else load_config(*args.config)
    if args.direction == "to-native":
        summary = to_native(args.src, args.out, cfg)
        for field, value in summary["dropped"].items():
            print(f"dropped {field} = {value} (apply_if_finite's counter; the port keeps none)")
    else:
        summary = from_native(args.src, args.out, cfg)
    print(f"{args.direction}: {args.src} -> {args.out}  " +
          "  ".join(f"{k}={v}" for k, v in summary.items() if k != "dropped"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
