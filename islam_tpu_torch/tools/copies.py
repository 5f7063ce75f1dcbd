"""The copy-like ops of a profiled window, by the bytes they move.

    python -m islam_tpu_torch.tools.copies [--epoch 0|1|2] [--bf16]
        [--concat-free] [--top N]

Counterpart of ``tools/dump_copies.py``, which lists the ``copy``
instructions of the JAX step's optimized HLO with their bytes and source
op.  Here the window is ``profile_window``'s (``tools/window.py``),
profiled with shapes and the Python stack, and every outermost
``aten::copy_``, ``aten::cat``, ``aten::contiguous``, ``aten::to`` and
``aten::clone`` is a copy (one under another counts once, as the outer
one).  Bytes moved: what the copy reads plus what it writes (a cat reads
its inputs and writes the output it allocates; the others, the ``copy_``
calls under them); an op that copies nothing (``contiguous`` of a contiguous tensor)
is left out.  Copies of one op, shapes, dtype, module and source line are a
row: calls, bytes and device ms per window.  It prints the top rows by
bytes, the totals per window, and by name the flow decoder's two passes
over the cost volume that ROADMAP's Queue 2 names: the concat of the cost
volume with the level's features (``models/pwcnet.py`` ``_level``) and
the decoders' DenseNet concats (``_decode``), which ``--concat-free``
removes, and the ``leaky_relu`` over the correlation (``_corr``), which is
not a copy but reads and writes the cost volume once.  Needs the card;
prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import defaultdict

import torch

from islam_tpu_torch.tools import h100
from islam_tpu_torch.tools import window as win
from islam_tpu_torch.tools.conv_roofline import itemsize
from islam_tpu_torch.tools.flops import _numel

COPY_OPS = ("aten::copy_", "aten::cat", "aten::contiguous", "aten::to",
            "aten::clone")
_PKG = "islam_tpu_torch" + os.sep
# (name, op, source file, function): the flow decoder's passes over the
# cost volume
NAMED = (("cost_volume_concat", "aten::cat", "models/pwcnet.py", "_level"),
         ("decoder_concat", "aten::cat", "models/pwcnet.py", "_decode"),
         ("cost_volume_leaky_relu", "aten::leaky_relu", "models/pwcnet.py",
          "_corr"))
_FRAME = re.compile(r"(.*)\((\d+)\): (.*)")


def frames(evt):
    """The port's frames of an op's Python stack, innermost first, as
    (file under the package, line, function)."""
    out = []
    for f in evt.stack or ():
        m = _FRAME.match(f)
        if m and _PKG in m.group(1):
            path = m.group(1).split(_PKG, 1)[1].replace(os.sep, "/")
            out.append((path, int(m.group(2)), m.group(3)))
    return out


def _copied_bytes(evt, dtypes):
    """Read plus written bytes of the ``copy_`` calls at or under ``evt``."""
    if evt.name == "aten::copy_":
        dst, src = evt.input_shapes[:2]
        dt = dtypes.get(evt.id) or ["float", "float"]
        return (_numel(dst) * itemsize(dt[0])
                + _numel(src) * itemsize(dt[1]))
    return sum(_copied_bytes(c, dtypes) for c in evt.cpu_children)


def cat_bytes(evt):
    """A cat reads its inputs and writes their concatenation, the output it
    allocates: twice that.  (The profiler records no shapes for a tensor
    list.)"""
    return 2 * win.allocated_bytes(evt)


def copy_rows(events, dtypes, modules):
    """{(op, shapes, dtypes, module, site): [calls, bytes, device ms]} of
    the outermost copy-like ops that move bytes."""
    rows = defaultdict(lambda: [0, 0, 0.0])
    for e in events:
        if e.name not in COPY_OPS or any(a.name in COPY_OPS
                                         for a in win.ancestors(e)):
            continue
        nbytes = (cat_bytes(e) if e.name == "aten::cat"
                  else _copied_bytes(e, dtypes))
        if not nbytes:
            continue
        fr = frames(e)
        site = "%s:%d %s" % fr[0] if fr else ""
        key = (e.name, json.dumps([s for s in e.input_shapes if s]),
               ",".join(d for d in (dtypes.get(e.id) or []) if d),
               modules(e), site)
        r = rows[key]
        r[0] += 1
        r[1] += nbytes
        r[2] += win.op_device_ms(e)
    return rows


def _caller(evt):
    """The innermost of the op's frames outside the layer helpers
    (``models/layers.py``), as (file, function)."""
    for path, _, fn in frames(evt):
        if path != "models/layers.py":
            return path, fn
    return None


def named_passes(events, dtypes):
    """{name: {calls, bytes, ms}} of ``NAMED``: each op called from the
    named function of the named file."""
    out = {n: {"calls": 0, "bytes": 0, "device_ms": 0.0} for n, *_ in NAMED}
    for e in events:
        for name, op, path, fn in NAMED:
            if e.name != op or _caller(e) != (path, fn):
                continue
            if op == "aten::cat":
                nbytes = cat_bytes(e)
            else:  # an elementwise pass: its input read, its output written
                dt = (dtypes.get(e.id) or ["float"])[0]
                nbytes = 2 * _numel(e.input_shapes[0]) * itemsize(dt)
            o = out[name]
            o["calls"] += 1
            o["bytes"] += nbytes
            o["device_ms"] += win.op_device_ms(e)
    return out


def copies(w: "win.Window", top=40) -> dict:
    """The copy report of a window profiled ``with_stack``."""
    events = w.prof.events()
    dtypes = win.dtypes_by_id(w.prof)
    rows = copy_rows(events, dtypes, win.Modules(events))
    n = w.windows
    listed = sorted(
        ({"op": k[0], "shapes": json.loads(k[1]), "dtypes": k[2],
          "module": k[3], "site": k[4], "calls": v[0],
          "mb_per_window": v[1] / n / 1e6, "device_ms_per_window": v[2] / n}
         for k, v in rows.items()), key=lambda r: -r["mb_per_window"])
    named = named_passes(events, dtypes)
    return {
        "epoch": w.epoch, "target": w.trainer.train_target[w.epoch],
        "bf16": w.trainer.args.bf16, "concat_free": w.trainer.concat_free,
        "windows": n,
        "copy_calls_per_window": sum(v[0] for v in rows.values()) / n,
        "mb_per_window": sum(v[1] for v in rows.values()) / n / 1e6,
        "device_ms_per_window": sum(v[2] for v in rows.values()) / n,
        "window_device_ms": win.device_ms(events) / n,
        "named": {k: {"calls_per_window": v["calls"] / n,
                      "mb_per_window": v["bytes"] / n / 1e6,
                      "device_ms_per_window": v["device_ms"] / n}
                  for k, v in named.items()},
        "top": listed[:top],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epoch", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--concat-free", action="store_true",
                   help="the flow net's decoders without concat buffers")
    p.add_argument("--top", type=int, default=40, help="rows listed")
    a = p.parse_args(argv)
    h100.require_card("copies")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = win.profile(a.epoch, bf16=a.bf16, concat_free=a.concat_free,
                    with_stack=True)
    out = copies(w, a.top)
    out["card"] = h100.card_line()
    out["tf32_flags"] = h100.tf32_flags()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
