"""The one generator of every traffic mix: a closed loop of clients over
the serving engine, read from a mix's data file (``chipbench/traffic``).

Every seed gets the same multiset of request sizes, in another order: the
prompt and output lengths of all ``clients x requests_per_client``
requests sit at evenly spaced points of their uniform ranges. Each client
holds ``requests_per_client`` (a power of two) of them, one in each of as
many equal strata of the range at a shift of its own, and cycles through
them in bit-reversed order (lowest, middle, quarter, three quarters...)
from a start of its own, so that any run of consecutive requests of a
client is spread over the range. The seed draws the clients' shifts and
starts, for prompts and outputs apart; so a window of the whole loop sees
nearly the same mix under every seed. Prompt ids are uniform over the
vocabulary, drawn from the seed, the client and the request's place in
the client's list, so the same seed gives the same inputs whatever the
timing.

The first wave (every client's first request, submitted together) takes
its output lengths at evenly spaced quantiles of the stationary residual
of the output-length law (the part of a request still to be served at a
random moment of a closed loop that has run long), so that completions
neither bunch nor come in waves; the warm-up then runs until
``warmup_completions`` requests have completed.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

KEYS = ("slots", "max_len", "clients", "prompt_tokens", "output_tokens",
        "requests_per_client", "warmup_completions", "trace_seconds",
        "check_requests")


@dataclass(frozen=True)
class Mix:
    name: str
    slots: int
    max_len: int
    clients: int
    prompt_tokens: Tuple[int, int]
    output_tokens: Tuple[int, int]
    requests_per_client: int
    warmup_completions: int
    trace_seconds: float
    check_requests: int


def load_mix(path: Path) -> Mix:
    raw = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in raw]
    if missing:
        raise ValueError(f"{path}: missing {missing}")
    mix = Mix(name=Path(path).stem, **{
        k: tuple(raw[k]) if isinstance(raw[k], list) else raw[k]
        for k in KEYS})
    longest = mix.prompt_tokens[1] + mix.output_tokens[1]
    if longest > mix.max_len:
        raise ValueError(f"{path}: a request of {longest} tokens does not "
                         f"fit a slot of {mix.max_len}")
    if mix.output_tokens[0] < 2:
        raise ValueError(f"{path}: the engine serves at least 2 tokens "
                         f"(a prefill's and a step's)")
    per = mix.requests_per_client
    if per < 1 or per & (per - 1):
        raise ValueError(f"{path}: requests_per_client must be a power of "
                         f"two, not {per}")
    return mix


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integers at evenly spaced points of ``[lo, hi]``."""
    return lo + ((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64)


def bit_reversed(n: int) -> np.ndarray:
    """0..n-1 (n a power of two) in bit-reversed order."""
    bits = n.bit_length() - 1
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
                     for i in range(n)])


def strata(lo: int, hi: int, per: int, clients: int,
           rng: np.random.Generator) -> np.ndarray:
    """(clients, per) sizes: client c's are the points ``(i + (s_c + 0.5)
    / clients) / per`` of ``[lo, hi]``, i taken in bit-reversed order from
    a start of its own; the shifts s_c (a permutation of the clients) and
    the starts are drawn from ``rng``. Together they are ``spread(lo, hi,
    clients * per)``."""
    shift = (rng.permutation(clients)[:, None] + 0.5) / clients
    start = rng.integers(0, per, clients)[:, None]
    order = bit_reversed(per)[(np.arange(per)[None, :] + start) % per]
    return lo + ((order + shift) * (hi - lo + 1) / per).astype(np.int64)


def residual_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` evenly spaced quantiles (at least 2) of the stationary
    residual of a length uniform on ``[lo, hi]``: its density is P(L >=
    r) / E[L] for r = 1..hi."""
    r = np.arange(1, hi + 1)
    survive = np.clip((hi - r + 1) / (hi - lo + 1), 0.0, 1.0)
    cdf = np.cumsum(survive) / survive.sum()
    q = (np.arange(n) + 0.5) / n
    return np.maximum(r[np.searchsorted(cdf, q)], 2)


class ClosedLoop:
    """The requests of a mix under one seed: ``next(c)`` gives client
    ``c``'s next prompt ids and output length."""

    def __init__(self, mix: Mix, seed: int, vocab_size: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab_size)
        rng = np.random.default_rng([self.seed, 0])
        per, c = mix.requests_per_client, mix.clients
        self.prompt_len = strata(*mix.prompt_tokens, per, c, rng)
        self.output_len = strata(*mix.output_tokens, per, c, rng)
        self.first_output = rng.permutation(
            residual_quantiles(*mix.output_tokens, mix.clients))
        self.count = [0] * mix.clients

    def _prompt(self, client: int, k: int) -> np.ndarray:
        n = int(self.prompt_len[client, k % self.mix.requests_per_client])
        rng = np.random.default_rng([self.seed, 1, client, k])
        return rng.integers(0, self.vocab, n, dtype=np.int64)

    def next(self, client: int) -> Tuple[np.ndarray, int]:
        """Client ``client``'s next request: (prompt ids, output tokens)."""
        k = self.count[client]
        self.count[client] += 1
        out = (int(self.first_output[client]) if k == 0 else
               int(self.output_len[client, k % self.mix.requests_per_client]))
        return self._prompt(client, k), out
