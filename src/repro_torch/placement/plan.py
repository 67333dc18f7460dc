"""Placement plans: per-service site assignment over a pipeline DAG.

A plan maps every service of a pipeline topology to a site: the DC
(``SITE_DC``) or an edge gateway. Single-gateway deployments use the
default ``SITE_EDGE`` name; multi-site fleets (``repro_torch.online``) use
one name per gateway — any site other than ``SITE_DC`` is edge-resident.
DC-resident services additionally carry a VDC sizing hint (chip count,
power of two ≥ 4, matching ``PodGrid.compose``) and a DVFS frequency
hint that the co-simulator forwards to the JITA-4DS scheduler.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.vdc import MIN_VDC_CHIPS, is_valid_vdc_size

SITE_EDGE = "edge"
SITE_DC = "dc"
SITES = (SITE_EDGE, SITE_DC)

Topology = Mapping[str, Sequence[str]]  # service -> upstream service names


@dataclasses.dataclass(frozen=True)
class ServicePlacement:
    site: str
    chips: int = 8          # VDC sizing hint (dc only)
    dvfs_f: float = 1.0     # DVFS hint (dc only)

    @property
    def is_edge(self) -> bool:
        return self.site != SITE_DC

    @property
    def label(self) -> str:
        if self.is_edge:
            return self.site
        return f"dc[{self.chips}]@{self.dvfs_f:g}"


class _Assignments(dict):
    """Plan assignment map that can be sealed: once the owning plan's
    canonical ``key()`` is computed (and possibly memoized on), any
    further mutation raises — a stale memo entry would silently score
    the wrong plan."""
    __slots__ = ("_sealed",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._sealed = False

    def _reject(self):
        raise TypeError("PlacementPlan is frozen once key() has been "
                        "computed; build a new plan with with_placement()")

    def __setitem__(self, k, v):
        if self._sealed:
            self._reject()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        if self._sealed:
            self._reject()
        super().__delitem__(k)

    def _guarded(name):  # noqa: N805 — tiny local factory
        orig = getattr(dict, name)

        def meth(self, *a, **kw):
            if self._sealed:
                self._reject()
            return orig(self, *a, **kw)
        meth.__name__ = name
        return meth

    update = _guarded("update")
    pop = _guarded("pop")
    popitem = _guarded("popitem")
    clear = _guarded("clear")
    setdefault = _guarded("setdefault")
    del _guarded

    def __reduce__(self):
        return (_rebuild_assignments, (dict(self), self._sealed))


def _rebuild_assignments(d, sealed):
    out = _Assignments(d)
    out._sealed = sealed
    return out


@dataclasses.dataclass
class PlacementPlan:
    assignments: Dict[str, ServicePlacement]

    def __post_init__(self):
        self.assignments = _Assignments(self.assignments)
        self._key: Optional[Tuple] = None

    # ------------------------------------------------------------ builders
    @classmethod
    def all_edge(cls, names: Sequence[str],
                 site: str = SITE_EDGE) -> "PlacementPlan":
        return cls({n: ServicePlacement(site) for n in names})

    @classmethod
    def all_dc(cls, names: Sequence[str], chips: int = 8,
               dvfs_f: float = 1.0) -> "PlacementPlan":
        return cls({n: ServicePlacement(SITE_DC, chips, dvfs_f)
                    for n in names})

    # ------------------------------------------------------------- queries
    def placement(self, name: str) -> ServicePlacement:
        return self.assignments[name]

    def site(self, name: str) -> str:
        return self.assignments[name].site

    def is_edge(self, name: str) -> bool:
        return self.assignments[name].is_edge

    def edge_services(self) -> List[str]:
        return [n for n, p in self.assignments.items() if p.is_edge]

    def dc_services(self) -> List[str]:
        return [n for n, p in self.assignments.items() if not p.is_edge]

    def cuts(self, topology: Topology) -> List[Tuple[str, str]]:
        """DAG edges (upstream, downstream) whose endpoints sit on
        different sites — each pays a network hop in the co-sim."""
        out = []
        for svc, ups in topology.items():
            for u in ups:
                if self.site(u) != self.site(svc):
                    out.append((u, svc))
        return out

    def key(self) -> Tuple:
        """Canonical hashable identity (for memoized search). Cached on
        first computation — search layers call this per memo/dedup
        lookup, and re-sorting the full assignment tuple every time
        dominated large-fleet dedup passes. Computing the key seals the
        plan against further assignment mutation."""
        k = self._key
        if k is None:
            k = tuple(sorted((n, p.site, p.chips if not p.is_edge else 0,
                              p.dvfs_f if not p.is_edge else 0.0)
                             for n, p in self.assignments.items()))
            self._key = k
            self.assignments._sealed = True
        return k

    @property
    def label(self) -> str:
        return ",".join(f"{n}={p.label}"
                        for n, p in sorted(self.assignments.items()))

    # ---------------------------------------------------------- validation
    def validate(self, topology: Topology, grid_chips: int = 256,
                 sites: Optional[Sequence[str]] = None) -> None:
        """Raise ValueError unless the plan covers exactly the topology's
        services with well-formed placements. ``sites`` is the allowed
        site universe (default: the classic single-gateway pair)."""
        allowed = set(sites) if sites is not None else set(SITES)
        names = set(topology)
        got = set(self.assignments)
        if got != names:
            missing, extra = names - got, got - names
            raise ValueError(f"plan/topology mismatch: missing={sorted(missing)}"
                             f" extra={sorted(extra)}")
        for svc, ups in topology.items():
            for u in ups:
                if u not in names:
                    raise ValueError(f"{svc!r} upstream {u!r} not in topology")
        for n, p in self.assignments.items():
            if p.site not in allowed:
                raise ValueError(f"{n}: unknown site {p.site!r} "
                                 f"(allowed: {sorted(allowed)})")
            if p.is_edge:
                continue
            if not is_valid_vdc_size(p.chips):
                raise ValueError(f"{n}: VDC chips hint must be a power of "
                                 f"two >= {MIN_VDC_CHIPS}, got {p.chips}")
            if p.chips > grid_chips:
                raise ValueError(f"{n}: chips hint {p.chips} exceeds the "
                                 f"pod grid ({grid_chips})")
            if not 0.0 < p.dvfs_f <= 1.0:
                raise ValueError(f"{n}: dvfs_f must be in (0, 1], "
                                 f"got {p.dvfs_f}")

    # ------------------------------------------------------------- JSON
    def to_dict(self) -> Dict[str, Dict]:
        """Structured JSON form (benchmarks record plans this way so
        regressions can replay them without parsing labels)."""
        return {n: {"site": p.site, "chips": p.chips, "dvfs_f": p.dvfs_f}
                for n, p in sorted(self.assignments.items())}

    @classmethod
    def from_dict(cls, d: Mapping[str, Mapping]) -> "PlacementPlan":
        return cls({n: ServicePlacement(v["site"], int(v.get("chips", 8)),
                                        float(v.get("dvfs_f", 1.0)))
                    for n, v in d.items()})

    # -------------------------------------------------------- enumeration
    def with_placement(self, name: str, placement: ServicePlacement
                       ) -> "PlacementPlan":
        d = dict(self.assignments)
        d[name] = placement
        return PlacementPlan(d)


def service_options(chips_options: Sequence[int] = (4, 8, 16),
                    dvfs_options: Sequence[float] = (1.0,),
                    edge_sites: Sequence[str] = (SITE_EDGE,)
                    ) -> List[ServicePlacement]:
    """The per-service choice set a search explores: one edge option per
    gateway site plus the DC chips×DVFS grid."""
    opts = [ServicePlacement(s) for s in edge_sites]
    for c in chips_options:
        for f in dvfs_options:
            opts.append(ServicePlacement(SITE_DC, c, f))
    return opts


def enumerate_plans(names: Sequence[str],
                    chips_options: Sequence[int] = (4, 8, 16),
                    dvfs_options: Sequence[float] = (1.0,),
                    edge_sites: Sequence[str] = (SITE_EDGE,)
                    ) -> Iterator[PlacementPlan]:
    """Exhaustive plan space: (|sites| + |chips|·|dvfs|)^n plans."""
    opts = service_options(chips_options, dvfs_options, edge_sites)
    for combo in itertools.product(opts, repeat=len(names)):
        yield PlacementPlan(dict(zip(names, combo)))
