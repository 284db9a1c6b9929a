"""Federated-run configuration: the port's own copy of ``FederatedConfig``
and ``FaultConfig`` from ``src/repro/configs/base.py``, with the same fields,
defaults and validation.  The port keeps a copy instead of importing the
reference so that it runs where JAX is not installed.

Every field is the reference's contract.  ``popstore`` and
``popstore_min_clients`` are read only by the reference's launchers, which
the port does not have yet; rounds ignore them, as the reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class FaultConfig:
    """Deterministic client-fault schedule, pure in ``(seed, round, client)``.

    ``dropout``/``straggler`` silence a client for the round, ``delay``
    lands its uplink late (silence when the async engine is off),
    ``corrupt`` mangles the transmitted packet."""

    dropout: float = 0.0    # P(client never returns this round)
    straggler: float = 0.0  # P(client misses the round barrier)
    delay: float = 0.0      # P(uplink delayed s rounds; silence if async off)
    corrupt: float = 0.0    # P(transmitted uplink mangled on the wire)
    blowup: float = 1e6     # magnitude multiplier of the "blowup" corruption
    seed: int = 1234        # fault RNG seed, independent of the data/mask seeds
    delay_max: int = 4      # lateness s drawn uniformly from [1, delay_max]

    def __post_init__(self):
        for name in ("dropout", "straggler", "delay", "corrupt"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(
                    f"fault rate {name} must be in [0, 1], got {v}")
        if self.delay_max < 1:
            raise ValueError(
                f"delay_max must be a positive lateness bound, got "
                f"{self.delay_max}")

    @property
    def any(self) -> bool:
        return (self.dropout > 0 or self.straggler > 0 or self.delay > 0
                or self.corrupt > 0)

    @classmethod
    def parse(cls, spec: str) -> "FaultConfig":
        """Build from a CLI spec string, e.g. ``"dropout=0.1,corrupt=0.05,seed=7"``."""
        kwargs = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            key, _, val = item.partition("=")
            key = key.strip()
            if key not in cls.__dataclass_fields__:
                raise ValueError(
                    f"unknown fault field {key!r} (have "
                    f"{sorted(cls.__dataclass_fields__)})")
            kwargs[key] = int(val) if key in ("seed", "delay_max") else float(val)
        return cls(**kwargs)


@dataclass(frozen=True)
class FederatedConfig:
    """How the paper's centralised-network optimisers run.  Field meanings
    are documented at length in the reference (``src/repro/configs/base.py``);
    the short notes here name what each selects."""

    algorithm: str = "gpdmm"  # gpdmm | agpdmm | scaffold | fedavg | fedsplit
    inner_steps: int = 2  # K in the paper
    # float (one global stepsize) | "auto" (resolve host-side first) |
    # tuple (one stepsize per client row)
    eta: float | str | Tuple[float, ...] = 1e-2
    rho: Optional[float] = None  # None -> 1/(K * mean eta)
    layout: str = "client_axis"  # client_axis | fsdp
    num_clients: Optional[int] = None
    use_avg: bool = True  # GPDMM dual update: eq. (23) x_bar vs eq. (24) x_K
    fedsplit_init: str = "z"
    gamma: Optional[float] = None  # FedSplit prox weight; None -> 1/rho
    eta_g: float = 1.0  # SCAFFOLD server stepsize
    uplink_bits: Optional[int] = None  # EF21-quantised uplink; None = exact
    participation: float = 1.0  # fraction of clients active per round
    cohort: bool | str = "auto"  # cohort-sampled engine (participation < 1)
    cohort_tile: Optional[int] = None
    popstore: bool | str = "auto"  # host-resident population store
    popstore_min_clients: int = 65_536
    seed: int = 17  # participation RNG seed
    # flat client-state arena: True | False | "auto" (arena iff the packed
    # width reaches arena_min_width)
    use_arena: bool | str = "auto"
    arena_min_width: int = 1024
    rounds_per_call: int = 1
    topology: str = "star"  # star | ring | complete | torus | er[:p]
    graph_schedule: str = "color"  # color | sync
    variance_reduction: Optional[str] = None  # None | "svrg"
    faults: Optional[FaultConfig] = None
    screen: bool | str = "auto"  # uplink screening
    screen_mult: float = 100.0
    async_rounds: bool | str = "auto"  # bounded-staleness engine
    deadline: float = float("inf")
    max_staleness: int = 0
    stale_gamma: float = 0.5
    tol: float = 0.0  # residual-based early termination; 0 = off
    patience: int = 1

    def __post_init__(self):
        if self.inner_steps < 1:
            raise ValueError(
                f"inner_steps must be >= 1, got {self.inner_steps}")
        if isinstance(self.eta, str):
            if self.eta != "auto":
                raise ValueError(
                    f"eta must be a positive stepsize, a tuple of them, or "
                    f"'auto', got {self.eta!r}")
        elif isinstance(self.eta, tuple):
            if not self.eta or any(
                    not (isinstance(e, (int, float)) and e > 0.0)
                    for e in self.eta):
                raise ValueError(
                    f"eta tuple must hold one positive per-client stepsize "
                    f"per row, got {self.eta!r}")
        elif not (isinstance(self.eta, (int, float)) and self.eta > 0.0):
            raise ValueError(
                f"eta must be a positive stepsize, got {self.eta!r}")
        if self.rho is not None and not self.rho > 0.0:
            raise ValueError(
                f"rho must be a positive penalty (or None for the 1/(K*eta) "
                f"default), got {self.rho}")
        if not self.tol >= 0.0:
            raise ValueError(
                f"tol must be >= 0 (0 disables early termination), got "
                f"{self.tol}")
        if self.patience < 1:
            raise ValueError(
                f"patience must be >= 1 consecutive sub-tol rounds, got "
                f"{self.patience}")
        if not (0.0 < self.participation <= 1.0):
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        if self.cohort not in (True, False, "auto"):
            raise ValueError(
                f"cohort must be True, False or 'auto', got {self.cohort!r}")
        if self.cohort_tile is not None and self.cohort_tile < 1:
            raise ValueError(
                f"cohort_tile must be a positive tile size or None, got "
                f"{self.cohort_tile}")
        if self.popstore not in (True, False, "auto"):
            raise ValueError(
                f"popstore must be True, False or 'auto', got "
                f"{self.popstore!r}")
        if self.popstore_min_clients < 1:
            raise ValueError(
                f"popstore_min_clients must be >= 1, got "
                f"{self.popstore_min_clients}")
        if self.screen not in (True, False, "auto"):
            raise ValueError(
                f"screen must be True, False or 'auto', got {self.screen!r}")
        if self.async_rounds not in (True, False, "auto"):
            raise ValueError(
                f"async_rounds must be True, False or 'auto', got "
                f"{self.async_rounds!r}")
        if not self.deadline > 0.0:
            raise ValueError(
                f"deadline must be a positive round count (inf = no "
                f"deadline), got {self.deadline}")
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}")
        if not (0.0 < self.stale_gamma <= 1.0):
            raise ValueError(
                f"stale_gamma must be in (0, 1], got {self.stale_gamma}")
        if (self.cohort_tile is not None and self.num_clients is not None
                and self.participation < 1.0):
            # local import: core imports configs
            from repro_torch.core.tree_util import cohort_count
            mc = cohort_count(self.num_clients, self.participation)
            if self.cohort_tile < mc and mc % self.cohort_tile:
                raise ValueError(
                    f"cohort_tile={self.cohort_tile} does not divide the "
                    f"cohort size {mc} (= ceil(participation="
                    f"{self.participation} * num_clients={self.num_clients}))")
