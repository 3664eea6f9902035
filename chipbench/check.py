"""The comparison that decides ``correct``: what the timed path served,
against the plain reference.

Once the window has closed, a sample of the requests it finished, drawn
from the seed and always holding the longest, is run through the
architecture's reference (``chipbench/reference/<arch>.py``) once: each
prompt with the tokens the engine served after it. At each position the
reference's best logit minus its logit of the token judged there is that
token's gap; the number compared is the mean gap of the judged tokens.
Greedy serving of a sound program gives gaps of rounding size; a wrong
token, a lost cache write or a row served another row's logits gives gaps
of the logits' own spread. (The widest gap is not compared: it is set by a
few near-ties and routing flips.)

The judged tokens are the served ones; with ``control`` they are those
that the control (the reference with fp8 products) puts first at the same
positions of the same sequences, so the control takes the program's place
in the one decision.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


#: a served request: (prompt ids, served ids)
Served = Tuple[Sequence[int], Sequence[int]]


def sample(finished: List[Served], seed: int, count: int) -> List[Served]:
    """``count`` finished requests: the longest (prompt and output), then
    others in an order drawn from the seed."""
    if not finished:
        return []
    sizes = [len(p) + len(s) for p, s in finished]
    first = int(np.argmax(sizes))
    rest = [i for i in np.random.default_rng([int(seed), 2]).permutation(
        len(finished)) if i != first]
    return [finished[i] for i in [first] + rest[:count - 1]]


def gaps(ref: List[torch.Tensor], tokens: List[torch.Tensor]) -> np.ndarray:
    """Each position's reference best logit minus its logit of the token
    ``tokens`` names there."""
    out = []
    for logits, tok in zip(ref, tokens):
        tok = tok.to(logits.device)
        best = logits.max(-1).values
        out.append((best - logits.gather(-1, tok[:, None])[:, 0]).cpu())
    return torch.cat(out).double().numpy()


def served_gap(reference, cfg: dict, weights, seqs: List[Served], device,
               control: bool = False) -> dict:
    """The mean and the widest gap of the judged tokens of ``seqs``
    (``reference``: the architecture's reference module); with
    ``control`` also the served tokens' mean gap on the same sample
    (``program_mean_logit_gap``)."""
    ref = reference.served_logits(cfg, weights, seqs, device)
    served = [torch.as_tensor(list(s), dtype=torch.int64) for _, s in seqs]
    out = {}
    judged = served
    if control:
        out["program_mean_logit_gap"] = float(gaps(ref, served).mean())
        low = reference.served_logits(cfg, weights, seqs, device,
                                      quant="fp8")
        judged = [c.argmax(-1) for c in low]
        del low
    g = gaps(ref, judged)
    out.update(mean_logit_gap=float(g.mean()), max_logit_gap=float(g.max()),
               served_tokens=int(g.size), requests=len(seqs))
    return out


def load_limits(path: Path) -> Dict[str, float]:
    """A cell's limits: ``{number: limit}`` from its checks file."""
    raw = json.loads(Path(path).read_text())
    return {k: float(v["limit"]) for k, v in raw["limits"].items()}
