"""String-keyed registries of the port's control plane.

The port keeps registries of its own instead of adding entries to the
reference's: the reference uses ``"torch"`` as its example of an unknown
backend, so a shared namespace would change what the reference accepts.

A :class:`Registry` maps each name to its implementation and rejects
unknown names with one error shape (``unknown <kind> 'x'; available:
(...)``).

========================  ========================  ==========================
registry                  entry                     defined in
========================  ========================  ==========================
:data:`CONTROLLERS`       sweep policy class        ``repro_torch.dsp.policies``
:data:`FORECASTERS`       scalar forecaster class   ``repro_torch.core.forecast``
:data:`FIT_BACKENDS`      GP fitter callable        ``repro_torch.core.demeter``
:data:`FORECAST_BACKENDS` forecaster factory        ``repro_torch.core.forecast_bank``
:data:`DETECTOR_BACKENDS` detector family class     ``repro_torch.core.anomaly``
:data:`SIM_ENGINES`       sweep executor class      ``repro_torch.dsp.executor``,
                                                    ``repro_torch.dsp.fused``
========================  ========================  ==========================
"""
from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, Optional, Tuple, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """An ordered name -> implementation mapping with uniform errors.

    ``kind`` is the noun used in error messages (``"engine"`` gives
    ``unknown engine 'x'; available: ('batched', 'fused')``).
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, obj: Optional[T] = None, *,
                 override: bool = False) -> Callable[[T], T]:
        """Register ``obj`` under ``name``; usable as a decorator.

        Re-registering an existing name raises unless ``override=True``.
        """
        if not name or not isinstance(name, str):
            raise ValueError(f"{self.kind} name must be a non-empty string, "
                             f"got {name!r}")

        def _install(o: T) -> T:
            if name in self._entries and not override:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered; pass "
                    f"override=True to replace it")
            self._entries[name] = o
            return o

        return _install if obj is None else _install(obj)

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str) -> T:
        """The entry for ``name``; raises the canonical ValueError if absent."""
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r}; "
                f"available: {self.available()}") from None

    def validate(self, name: str) -> str:
        """Check ``name`` is registered (canonical error) and return it."""
        self.get(name)
        return name

    def available(self) -> Tuple[str, ...]:
        """Registered names, sorted (the tuple shown in error messages)."""
        return tuple(sorted(self._entries))

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, entries={self.available()})"


#: Sweep controller policies ("static" / "reactive" / "ds2" / "demeter" +
#: plugins).
CONTROLLERS: Registry = Registry("controller")

#: TSF forecaster kinds ("arima" / "holt" / "seasonal" + plugins). Entries are
#: the scalar zoo classes; the batched ForecastBank mirrors the built-ins.
FORECASTERS: Registry = Registry("forecaster")

#: GP fitting backends ("bank" / "scalar"). Entries fit a batch of datasets:
#: ``fitter(datasets, seeds, device) -> list[GP]``.
FIT_BACKENDS: Registry = Registry("fit backend")

#: TSF execution backends ("bank" / "scalar"). Entries build one forecaster:
#: ``factory(kind, horizon=..., device=..., **kwargs) -> forecaster``.
FORECAST_BACKENDS: Registry = Registry("forecast backend")

#: Anomaly-detector backends of RecoveryTracker ("scalar" / "bank"). Entries
#: build one detector set: ``backend(metrics, device) -> impl``.
DETECTOR_BACKENDS: Registry = Registry("detector backend")

#: Sweep simulation engines ("batched" / "fused" / "scalar"). Entries subclass
#: :class:`repro_torch.dsp.executor.SweepExecutorBase`; an engine with
#: ``supports_intervals = True`` is driven a decision interval at a time.
SIM_ENGINES: Registry = Registry("engine")
