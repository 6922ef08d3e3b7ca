"""Seeded production-shaped traffic — diurnal tides, bursts, heavy tails.

The paper's premise is that a platform is only trusted after it has been
driven with production-shaped load (PPoDS: measure step by step under a
dynamic network).  Internet-facing serving does not offer uniform load:
request *rates* ride a diurnal sinusoid (a multi-site deployment sees
each region's day shifted in phase), flash crowds arrive as Poisson
bursts on top of the tide, and request *sizes* are heavy-tailed — most
prompts are short, a few are enormous (Zipf), generation lengths spread
lognormally.

Everything here is deterministic from an integer seed: the same
``TrafficShape`` replays the same arrival trace, the property the replay
harness (and the hypothesis tests) depends on.  Child RNG streams are
derived from the seed with fixed offsets so arrivals, bursts and length
draws stay independent but reproducible.

A copy of the JAX package's ``scenarios/traffic.py`` (numpy only): the
same ``RandomState`` streams, so one seed gives the same trace on both
stacks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

# fixed child-stream offsets: one RandomState per concern, all derived
# from TrafficShape.seed, so adding draws to one stream never shifts
# another (arrival determinism survives feature growth)
_ARRIVALS, _BURSTS, _PROMPTS, _GENS = 101, 211, 307, 401


@dataclass(frozen=True)
class DiurnalRate:
    """A sinusoidal request rate between ``base_rps`` (trough) and
    ``peak_rps`` (crest) with period ``period_s``.  ``phase_s`` shifts
    the crest — two tenants with opposite phases model regions whose
    days alternate on the shared fabric."""
    base_rps: float
    peak_rps: float
    period_s: float = 86400.0
    phase_s: float = 0.0

    def __post_init__(self):
        if self.base_rps < 0 or self.peak_rps < self.base_rps:
            raise ValueError("need 0 <= base_rps <= peak_rps")
        if self.period_s <= 0:
            raise ValueError("period_s must be positive")

    def rate(self, t: float) -> float:
        mid = 0.5 * (self.base_rps + self.peak_rps)
        amp = 0.5 * (self.peak_rps - self.base_rps)
        return mid + amp * math.cos(
            2 * math.pi * (t - self.phase_s) / self.period_s)

    @property
    def mean_rps(self) -> float:
        # the sinusoid's average over any whole period
        return 0.5 * (self.base_rps + self.peak_rps)


@dataclass(frozen=True)
class BurstOverlay:
    """Flash crowds: burst onsets arrive as a Poisson process at
    ``rate_per_s``; each burst adds ``extra_rps`` for ``duration_s``."""
    rate_per_s: float
    extra_rps: float
    duration_s: float

    def __post_init__(self):
        if min(self.rate_per_s, self.extra_rps, self.duration_s) < 0:
            raise ValueError("burst parameters must be non-negative")


@dataclass(frozen=True)
class TrafficShape:
    """One tenant's replayable traffic: rate process + size process.

    Prompt lengths are Zipf(``zipf_a``) clamped to [1, max_prompt_len];
    generation lengths are lognormal(``gen_mu``, ``gen_sigma``) clamped
    to [1, max_new_tokens].
    """
    name: str
    rate: DiurnalRate
    bursts: Optional[BurstOverlay] = None
    zipf_a: float = 1.8
    max_prompt_len: int = 32
    gen_mu: float = 1.6          # exp(1.6) ~ 5 tokens median
    gen_sigma: float = 0.6
    max_new_tokens: int = 16
    seed: int = 0

    def __post_init__(self):
        if self.zipf_a <= 1.0:
            raise ValueError("zipf_a must be > 1")
        if self.max_prompt_len < 1 or self.max_new_tokens < 1:
            raise ValueError("length caps must be >= 1")

    def _rng(self, stream: int) -> np.random.RandomState:
        return np.random.RandomState((self.seed * 1_000_003 + stream)
                                     % (2 ** 31 - 1))

    # ------------------------------------------------------------- rates
    def burst_times(self, horizon_s: float) -> List[float]:
        """Deterministic burst onsets in [0, horizon_s)."""
        if self.bursts is None or self.bursts.rate_per_s <= 0:
            return []
        rng = self._rng(_BURSTS)
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / self.bursts.rate_per_s)
            if t >= horizon_s:
                return out
            out.append(t)

    def rate_at(self, t: float, burst_times: Optional[List[float]] = None
                ) -> float:
        """Instantaneous rps: the diurnal tide plus any active bursts."""
        r = self.rate.rate(t)
        if self.bursts is not None:
            if burst_times is None:
                burst_times = self.burst_times(t + 1.0)
            r += self.bursts.extra_rps * sum(
                1 for b in burst_times if b <= t < b + self.bursts.duration_s)
        return r

    def max_rps(self) -> float:
        return self.rate.peak_rps + (
            self.bursts.extra_rps if self.bursts else 0.0)

    def mean_rps(self) -> float:
        """Expected rps over a whole period: diurnal mean + expected
        burst contribution (rate x duration x extra)."""
        extra = 0.0
        if self.bursts is not None:
            extra = (self.bursts.rate_per_s * self.bursts.duration_s *
                     self.bursts.extra_rps)
        return self.rate.mean_rps + extra

    def arrivals(self, horizon_s: float) -> List[float]:
        """Arrival times in [0, horizon_s): a non-homogeneous Poisson
        process sampled by thinning against ``max_rps``.  Same seed,
        same horizon => identical trace."""
        lam = self.max_rps()
        if lam <= 0 or horizon_s <= 0:
            return []
        rng = self._rng(_ARRIVALS)
        bursts = self.burst_times(horizon_s)
        out, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / lam)
            if t >= horizon_s:
                return out
            if rng.uniform() * lam <= self.rate_at(t, bursts):
                out.append(t)

    # ------------------------------------------------------------ lengths
    def prompt_lengths(self, n: int) -> np.ndarray:
        """Heavy-tailed (Zipf) prompt lengths, always in
        [1, max_prompt_len]."""
        if n <= 0:
            return np.zeros(0, dtype=np.int64)
        draws = self._rng(_PROMPTS).zipf(self.zipf_a, size=n)
        return np.minimum(draws, self.max_prompt_len).astype(np.int64)

    def gen_lengths(self, n: int) -> np.ndarray:
        """Lognormal generation lengths, always in [1, max_new_tokens]."""
        if n <= 0:
            return np.zeros(0, dtype=np.int64)
        draws = self._rng(_GENS).lognormal(self.gen_mu, self.gen_sigma,
                                           size=n)
        return np.clip(draws.astype(np.int64), 1,
                       self.max_new_tokens)

    # ----------------------------------------------------------- requests
    def requests(self, horizon_s: float, *, vocab_size: int) -> List[Dict]:
        """The full replayable request trace: one ServeJob-shaped request
        dict per arrival, tagged with its sim-time ``t`` so the driver
        can slice the trace into windows."""
        times = self.arrivals(horizon_s)
        n = len(times)
        plens = self.prompt_lengths(n)
        gens = self.gen_lengths(n)
        rng = self._rng(_PROMPTS + 7)
        out = []
        for i, t in enumerate(times):
            prompt = rng.randint(0, vocab_size,
                                 size=int(plens[i])).tolist()
            out.append({"id": f"{self.name}-{i}", "t": float(t),
                        "prompt": prompt,
                        "max_new_tokens": int(gens[i])})
        return out


def slice_window(requests: List[Dict], t0: float, t1: float) -> List[Dict]:
    """The requests of a trace that arrive in sim-window [t0, t1)."""
    return [r for r in requests if t0 <= r["t"] < t1]
