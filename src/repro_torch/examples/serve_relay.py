"""End-to-end serving example (the paper's kind: serving), port of
``examples/serve_relay.py``: boots a live RelayGR service —
sequence-aware trigger, affinity router, HBM window, DRAM expander,
optional cold store, all orchestrated by the shared event-driven
RelayRuntime — over the port's HSTU model and replays a synthetic
request stream through the full retrieval -> preprocess -> rank relay,
printing the hit breakdown and the trigger's admission ledger.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_relay
on the card; arguments, if any, replace the defaults below (add
``--device cpu`` to them for the CPU).  Every serving axis of
``repro_torch.launch.serve`` is available (see ``--help``): ``--sim``,
``--batched --max-batch 8``, ``--page-tokens 64 --segments``,
``--hosts 2 --prefill-hosts 1``, ``--dram-budget 4e9 --cold-budget
500e9``.
"""
import sys

from repro_torch.launch.serve import main

DEFAULTS = ["--requests", "100", "--qps", "150"]

if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULTS)
