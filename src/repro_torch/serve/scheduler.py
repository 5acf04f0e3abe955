"""Prefill/decode scheduler for the paged serving engine (a copy of
``repro.serve.scheduler``: pure Python, copied rather than imported).

Two jobs:

1. **Bucketed prefill lengths.**  Prompts are right-padded to the next
   bucket (default powers of two), so the prefill runs at one shape
   per *bucket*, not one per distinct prompt length — under real
   traffic the set of prefill shapes (and of their GEMM plans) is
   bounded and admissions after warmup plan nothing new.  Families
   with recurrent prompt state (ssm/hybrid) must prefill at the exact
   length (pad tokens would pollute the SSM state), so they bypass
   bucketing.

2. **Admission control.**  ``plan_admits`` packs prefills into steps
   where decode lanes sit idle: on a cold engine (no active lanes) every
   free lane fills at once, but while decodes are in flight at most
   ``max_prefills_per_step`` requests join per step — a prefill is a
   long serial pass, and admitting a whole burst at once would stall
   every in-flight decode behind it (the classic prefill/decode
   interference the paper's host program avoids by keeping the array
   saturated).  Admission is FCFS and stops at the first request that
   does not fit (lanes or blocks), so a large request at the head
   cannot be starved by small ones slipping past it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    #: prefill-length buckets (ascending); prompts longer than the last
    #: bucket prefill at their exact length
    prefill_buckets: tuple = (8, 16, 32, 64, 128, 256, 512)
    #: pad prompts to bucket lengths (families with recurrent prompt
    #: state force exact lengths regardless)
    bucketed: bool = True
    #: max prefills admitted per step while decodes are in flight; a
    #: cold engine (zero active lanes) fills every free lane at once
    max_prefills_per_step: int = 2


class Scheduler:
    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()

    def bucket_for(self, prompt_len: int, *, exact: bool = False) -> int:
        """Padded prefill length for a prompt (== prompt_len if exact
        lengths are forced or the prompt exceeds every bucket)."""
        if exact or not self.config.bucketed:
            return prompt_len
        for b in self.config.prefill_buckets:
            if b >= prompt_len:
                return b
        return prompt_len

    def plan_admits(self, needs: list, *, free_lanes: int,
                    free_blocks: int, n_active: int) -> int:
        """How many queued requests (FCFS prefix) to admit this step.

        ``needs``: per queued request, the block count its admission
        allocates.  Stops at the first request that does not fit —
        head-of-line blocking is deliberate (no starvation)."""
        if free_lanes <= 0 or not needs:
            return 0
        budget = free_lanes if n_active == 0 else min(
            free_lanes, self.config.max_prefills_per_step)
        admits = 0
        blocks_left = free_blocks
        for need in needs:
            if admits >= budget or need > blocks_left:
                break
            admits += 1
            blocks_left -= need
        return admits
