"""One query for every routing decision, as in the JAX package's
``repro/core/reports.py``.

The port keeps four registries of trace-time routing decisions apart —
``models.backends.fallback_reports`` (a requested backend could not serve
a request), ``models.attention.compact_seam_reports`` (the compact seam
taken or not), ``models.attention.ring_reports`` (Ring-SFA taken or not,
and its transport) and ``core.remat.remat_reports`` (the remat policy
applied for the one requested). This module is the protocol they all
speak:

  * ``Report`` — the normalized record: ``component`` (which subsystem made
    the decision), ``where`` (the site, e.g. ``"llama3.2-3b/attention"``),
    ``eligible`` (did the requested fast path engage), ``reason`` (why not,
    when it did not) and ``details`` (component-specific extras as sorted
    pairs: the selected backend, the fused-forward flag, ...).
  * ``register_provider(component, collect, clear)`` — each subsystem
    registers a read-only adapter from its native records to ``Report``s
    when it is imported; the native records stay where they are.
  * ``collect_reports(component=None)`` — every decision since the last
    clear, across all registered components (or one).
  * ``clear_reports(component=None)`` — reset between runs and tests.

The components are the reference's four: "backend", "compact_seam",
"remat" and "ring". The native accessors (``fallback_reports()`` etc.)
keep working.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Report:
    """One normalized routing decision."""
    component: str                   # "backend" | "compact_seam" | "ring" | "remat"
    where: str                       # site, e.g. "llama3.2-3b/attention"
    eligible: bool                   # requested fast path engaged?
    reason: Optional[str] = None     # set when not eligible
    details: Tuple[Tuple[str, Any], ...] = ()   # sorted extra fields

    def detail(self, key: str, default=None):
        for k, v in self.details:
            if k == key:
                return v
        return default


def make_report(component: str, where: str, eligible: bool,
                reason: Optional[str] = None,
                details: Optional[Dict[str, Any]] = None) -> Report:
    return Report(component=component, where=where, eligible=eligible,
                  reason=reason, details=tuple(sorted((details or {}).items())))


_PROVIDERS: Dict[str, Tuple[Callable[[], Tuple[Report, ...]], Callable[[], None]]] = {}


def register_provider(component: str, collect: Callable[[], Tuple[Report, ...]],
                      clear: Callable[[], None]) -> None:
    """Register (or replace) a component's report adapter."""
    _PROVIDERS[component] = (collect, clear)


def components() -> Tuple[str, ...]:
    return tuple(sorted(_PROVIDERS))


def collect_reports(component: Optional[str] = None) -> Tuple[Report, ...]:
    """Every routing decision since the last clear, across all components
    (or just ``component``). Order: by component name, then provider order."""
    if component is not None:
        return tuple(_PROVIDERS[component][0]())
    return tuple(r for name in components() for r in _PROVIDERS[name][0]())


def clear_reports(component: Optional[str] = None) -> None:
    for name in (component,) if component is not None else components():
        _PROVIDERS[name][1]()
