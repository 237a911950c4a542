#!/usr/bin/env python3
"""Each phase's wall in a checkout's ``chip_smoke.py``, on the card.

    python3 tools/phase_walls.py DIR [chip_smoke.py arguments]

Imports ``DIR/chip_smoke.py`` (its own ``DIR/src`` on the path), wraps
every module-level function whose name ends in ``_phase`` in a timer
and runs its ``main``, so that two commits' runs, each unpacked into a
directory, are timed alike.  After the script's own output it prints
one line, ``{"phase_walls": {phase: s, ...}, "total_s": s,
"outside_phases_s": s, "rc": code}``: the time outside the phases is
the kernels' build and the card's queries.  Needs the card
``chip_smoke.py`` needs.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0])
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod      # the ranks a phase spawns import it
    sys.path.insert(0, root)
    spec.loader.exec_module(mod)
    walls = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                walls[name] = time.perf_counter() - t0
        return run

    for name, fn in list(vars(mod).items()):
        if name.endswith("_phase") and callable(fn):
            setattr(mod, name, timed(name[:-len("_phase")], fn))
    t0 = time.perf_counter()
    rc = mod.main(argv[1:])
    total = time.perf_counter() - t0
    print(json.dumps({"phase_walls": walls, "total_s": total,
                      "outside_phases_s": total - sum(walls.values()),
                      "rc": rc}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
