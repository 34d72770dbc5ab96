"""zlint — the AST invariant linter, run over the port's own tree.

The engine's correctness story rests on replicated-state-machine determinism:
replay must rebuild byte-identical state, so appliers and state facades can
never touch wall clocks, RNGs, or iteration-order-sensitive constructs; no
code may query the CUDA card in-process outside the killable probe and the
places that run after it; pump hooks must never block; ingress/query
threads must read through committed accessors; device results reach a
transaction only through the kernel backend's fault seam. zlint
machine-checks these invariants instead of leaving them to review.

Entry points (stdlib-only — the linter never imports torch):

- ``run_lint(root)``        → list[Finding] over ``zeebe_tpu_torch/`` and
  ``chip_smoke.py``
- ``python -m zeebe_tpu_torch.cli lint [--check] [--update-baseline]``
- ``python -m zeebe_tpu_torch.cli knobs-doc [--check]`` (env-knob drift gate)

The rules are the reference's eight, with the port's paths; rule 2 names
the ``torch.cuda`` queries and rule 8 the port's device-result primitives.
"""

from zeebe_tpu_torch.analysis.framework import (
    BASELINE_FILENAME,
    Finding,
    format_baseline,
    load_baseline,
    run_lint,
    split_findings,
)
from zeebe_tpu_torch.analysis.knobs import render_knobs_doc, scan_knobs
from zeebe_tpu_torch.analysis.rules import RULES

# copied from the reference: __all__ .. __all__
__all__ = [
    "BASELINE_FILENAME",
    "Finding",
    "RULES",
    "format_baseline",
    "load_baseline",
    "render_knobs_doc",
    "run_lint",
    "scan_knobs",
    "split_findings",
]
# end of the copy
