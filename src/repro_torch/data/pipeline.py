"""Synthetic data pipelines.

* :class:`TokenStream` — deterministic synthetic LM token batches (a
  Zipf-ish unigram mixture with induced bigram structure so a model can
  actually reduce loss — used by the end-to-end training example).
* :func:`weather_dataset` — the paper's workload: synthetic weather-CSV
  rows (features -> next-day temperature with linear ground truth + noise),
  including CSV encode/parse so the serving example exercises a real
  ingest path.
"""
from __future__ import annotations

import dataclasses
import io

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # bigram transition structure: each token prefers a few successors
        self._succ = rng.randint(0, self.vocab, size=(self.vocab, 4))
        base = rng.zipf(1.5, size=self.vocab * 4).astype(np.float64)
        self._unigram = base[: self.vocab] / base[: self.vocab].sum()
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 1_000_003 + self._step)
        self._step += 1
        B, S = self.batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.vocab, size=B)
        follow = rng.rand(B, S) < 0.8
        choice = rng.randint(0, 4, size=(B, S))
        randtok = rng.randint(0, self.vocab, size=(B, S))
        for t in range(S):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, randtok[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# Weather workload (the paper's use case)
# ---------------------------------------------------------------------------

WEATHER_COLUMNS = ("day", "temp", "humidity", "pressure", "wind", "temp_next")


def make_weather_csv(n_rows: int, seed: int = 0) -> str:
    """Synthetic weather history for one location. Ground truth:
    temp_next = 0.8*temp - 3*humidity + 0.02*pressure - 0.1*wind + noise."""
    rng = np.random.RandomState(seed)
    day = np.arange(n_rows)
    temp = 15 + 10 * np.sin(2 * np.pi * day / 365.0) + rng.normal(0, 2, n_rows)
    humidity = np.clip(rng.normal(0.6, 0.15, n_rows), 0, 1)
    pressure = rng.normal(1013, 8, n_rows)
    wind = np.abs(rng.normal(12, 6, n_rows))
    temp_next = (
        0.8 * temp - 3.0 * humidity + 0.02 * pressure - 0.1 * wind
        + rng.normal(0, 0.5, n_rows)
    )
    buf = io.StringIO()
    buf.write(",".join(WEATHER_COLUMNS) + "\n")
    for i in range(n_rows):
        buf.write(
            f"{day[i]},{temp[i]:.3f},{humidity[i]:.4f},{pressure[i]:.2f},"
            f"{wind[i]:.3f},{temp_next[i]:.3f}\n"
        )
    return buf.getvalue()


def parse_weather_csv(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (X (n, 4+intercept), y (n,)) feature matrix / target."""
    lines = text.strip().split("\n")
    header = lines[0].split(",")
    assert tuple(header) == WEATHER_COLUMNS, header
    rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
    X = rows[:, 1:5]
    y = rows[:, 5]
    X = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    return X, y


def linear_regression(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Closed-form normal-equation solve (the paper's 'analysis' step).
    Done in JAX in examples/weather_workflow.py; numpy here for the
    pipeline unit tests."""
    return np.linalg.lstsq(X, y, rcond=None)[0]
