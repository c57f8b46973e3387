"""Continuous-batching serving of the spiking GPT, dense or block-paged."""

from repro_torch.serving.pages import PagePool
from repro_torch.serving.scheduler import BatchScheduler, Request, ServeStats
from repro_torch.serving.state import (NULL_PAGE, RESERVED_PAGES, TRASH_PAGE,
                                       DecodeState, PagedDecodeState,
                                       content_keys, init_paged_state,
                                       init_state, paged_admit_slot,
                                       paged_release_slot, pool_copy_page,
                                       pool_zero_pages, release_slot,
                                       splice_request)

__all__ = ["BatchScheduler", "Request", "ServeStats", "PagePool",
           "DecodeState", "PagedDecodeState", "NULL_PAGE", "TRASH_PAGE",
           "RESERVED_PAGES", "content_keys", "init_state", "init_paged_state",
           "release_slot", "splice_request", "paged_admit_slot",
           "paged_release_slot", "pool_copy_page", "pool_zero_pages"]
