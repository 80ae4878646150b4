"""repro_torch.analysis: the port's reprolint (static checks) and the
runtime sanitizer of its twins.

The static side (``framework``, ``rules``, ``cli``; ``python -m
repro_torch.analysis``) is the counterpart of ``repro/analysis``'s and is
stdlib-only, so it lints without torch. Its rules are RPL004 (spec
safety), RPL006 (a device->host sync inside a timed region) and RPL007 (a
draw from a global generator); ``rules``' docstring says why the
reference's jax-only rules are not ported. The reference's linter still
scans this package as it is.

``repro_torch.analysis.sanitize`` (the counterpart of
``repro/analysis/sanitize.py``) imports torch and is deliberately *not*
imported here: import it explicitly where needed.
"""
from repro_torch.analysis import rules  # noqa: F401  (registers the rule set)
from repro_torch.analysis.framework import (ERROR, RULES, WARNING, Finding, Rule,
                                            SourceModule, analyze_source, register,
                                            run)

__all__ = [
    "ERROR",
    "WARNING",
    "Finding",
    "Rule",
    "RULES",
    "SourceModule",
    "analyze_source",
    "register",
    "rules",
    "run",
]
