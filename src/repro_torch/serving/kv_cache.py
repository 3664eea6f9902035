"""Slot-based KV cache management for continuous batching (a copy of the
reference's ``repro/serving/kv_cache.py``).

The device cache is a fixed arena of ``n_slots`` sequences x ``max_len``
positions (family-appropriate layout from models.init_cache). The manager
owns the host-side bookkeeping: free-slot allocation, per-slot lengths, and
the memory budget Demeter's ``kv_blocks`` parameter controls. Lengths ride
into the decode kernel (ragged attention masks unwritten positions), so
slots of different ages batch together — classic continuous batching.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class SlotState:
    request_id: Optional[str] = None
    length: int = 0
    max_tokens: int = 0
    generated: int = 0


@dataclass
class KVCacheManager:
    n_slots: int
    max_len: int
    slots: List[SlotState] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.slots = [SlotState() for _ in range(self.n_slots)]

    # -- allocation ----------------------------------------------------------
    def allocate(self, request_id: str, prompt_len: int,
                 max_tokens: int) -> Optional[int]:
        if prompt_len + max_tokens > self.max_len:
            raise ValueError("request exceeds cache max_len")
        for idx, s in enumerate(self.slots):
            if s.request_id is None:
                self.slots[idx] = SlotState(request_id, prompt_len,
                                            max_tokens, 0)
                return idx
        return None

    def release(self, idx: int) -> None:
        self.slots[idx] = SlotState()

    # -- views ---------------------------------------------------------------
    def lengths(self) -> np.ndarray:
        return np.asarray([s.length for s in self.slots], np.int32)

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s.request_id is not None]

    def occupancy(self) -> float:
        return len(self.active()) / max(self.n_slots, 1)

    def advance(self, idx: int) -> SlotState:
        s = self.slots[idx]
        s.length += 1
        s.generated += 1
        return s

    def done(self, idx: int) -> bool:
        s = self.slots[idx]
        return s.generated >= s.max_tokens
