"""Path-keyed tree flattening.

Port of ``flatten_named`` from
``deepspeed_tpu/runtime/checkpoint_engine/sharded_checkpoint_engine.py``,
copied as it is: weight publications key their leaves by it. The
checkpoint engine itself waits with checkpointing (ROADMAP.md, port queue
item 8)."""


def flatten_named(tree, prefix=""):
    """Flatten a nested dict/list/tuple tree into ``[(path, leaf)]`` with
    deterministic, structure-independent path strings: dict keys joined
    with ``/``, sequence positions as ``#i``. Sorting is by path so two
    trees with different dict insertion orders align identically."""
    out = []

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node.keys(), key=str):
                rec(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}/#{i}" if path else f"#{i}")
        else:
            out.append((path, node))

    rec(tree, prefix)
    return out
