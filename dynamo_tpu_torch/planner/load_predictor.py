"""Load predictors: forecast the next interval's request rate / token loads.

Parity: reference ``planner/utils/load_predictor.py:36-132`` (constant,
ARIMA, Prophet). The image carries neither statsmodels nor prophet, so the
family here is dependency-free: constant (last value), EWMA, a
linear-trend regressor, and additive Holt-Winters triple exponential
smoothing — the seasonal case is what Prophet exists for (daily/weekly
request-rate cycles), and Holt-Winters covers it with ~40 lines of state
updates instead of a dependency.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional

import numpy as np


class BasePredictor:
    def __init__(self, window: int = 60):
        self.history: Deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        self.history.append(float(value))

    def predict(self) -> Optional[float]:
        raise NotImplementedError


class ConstantPredictor(BasePredictor):
    """Next value = last observed value."""

    def predict(self) -> Optional[float]:
        return self.history[-1] if self.history else None


class EwmaPredictor(BasePredictor):
    """Exponentially weighted moving average."""

    def __init__(self, window: int = 60, alpha: float = 0.3):
        super().__init__(window)
        self.alpha = alpha
        self._ewma: Optional[float] = None

    def observe(self, value: float) -> None:
        super().observe(value)
        self._ewma = (value if self._ewma is None
                      else self.alpha * value + (1 - self.alpha) * self._ewma)

    def predict(self) -> Optional[float]:
        return self._ewma


class TrendPredictor(BasePredictor):
    """Least-squares linear trend over the window, extrapolated one step;
    clamped at zero (a rate can't be negative)."""

    def predict(self) -> Optional[float]:
        n = len(self.history)
        if n == 0:
            return None
        if n < 3:
            return self.history[-1]
        y = np.asarray(self.history, np.float64)
        x = np.arange(n, dtype=np.float64)
        slope, intercept = np.polyfit(x, y, 1)
        return max(0.0, slope * n + intercept)


class SeasonalPredictor(BasePredictor):
    """Additive Holt-Winters (triple exponential smoothing): level + trend
    + a repeating seasonal profile of ``season`` observations — the
    daily/weekly request-rate cycle case the reference reaches for Prophet
    on (``planner/utils/load_predictor.py``, PROPHET_AVAILABLE branch).

    State updates per observation (standard additive form):
      level_t  = a*(y - seas_{t-m}) + (1-a)*(level + trend)
      trend_t  = b*(level_t - level) + (1-b)*trend
      seas_t   = g*(y - level_t)    + (1-g)*seas_{t-m}
    One-step forecast: level + trend + seas_{t+1-m}, clamped at zero.
    Until a full season has been observed it behaves like trend-corrected
    EWMA (seasonal terms start at zero)."""

    def __init__(self, window: int = 240, season: int = 60,
                 alpha: float = 0.35, beta: float = 0.05,
                 gamma: float = 0.25):
        super().__init__(max(window, 2 * season))
        if season < 2:
            raise ValueError(f"season must be >= 2, got {season}")
        self.season = season
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self._level: Optional[float] = None
        self._trend = 0.0
        self._seasonal = [0.0] * season
        self._t = 0

    def observe(self, value: float) -> None:
        super().observe(value)
        i = self._t % self.season
        self._t += 1
        if self._t <= self.season:
            # classic HW bootstrap: buffer the first full season, then
            # initialize level = its mean and the seasonal profile from the
            # deviations — starting the cycle already learned instead of
            # letting the level chase it for several seasons
            self._boot = getattr(self, "_boot", [])
            self._boot.append(float(value))
            self._level = float(np.mean(self._boot))
            if self._t == self.season:
                self._seasonal = [v - self._level for v in self._boot]
                del self._boot
            return
        seas = self._seasonal[i]
        prev_level = self._level
        self._level = (self.alpha * (value - seas)
                       + (1 - self.alpha) * (prev_level + self._trend))
        self._trend = (self.beta * (self._level - prev_level)
                       + (1 - self.beta) * self._trend)
        self._seasonal[i] = (self.gamma * (value - self._level)
                             + (1 - self.gamma) * seas)

    def predict(self) -> Optional[float]:
        if self._level is None:
            return None
        seas = self._seasonal[self._t % self.season]
        return max(0.0, self._level + self._trend + seas)


def make_predictor(kind: str, window: int = 60, **kw) -> BasePredictor:
    kinds = {"constant": ConstantPredictor, "ewma": EwmaPredictor,
             "trend": TrendPredictor, "seasonal": SeasonalPredictor}
    if kind not in kinds:
        raise ValueError(f"unknown predictor {kind!r}; choose {sorted(kinds)}")
    return kinds[kind](window=window, **kw)


__all__ = ["BasePredictor", "ConstantPredictor", "EwmaPredictor",
           "TrendPredictor", "SeasonalPredictor", "make_predictor"]
