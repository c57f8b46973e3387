"""Dense continuous-batching serving of the spiking GPT."""

from repro_torch.serving.scheduler import BatchScheduler, Request, ServeStats
from repro_torch.serving.state import (DecodeState, content_keys, init_state,
                                       release_slot, splice_request)

__all__ = ["BatchScheduler", "Request", "ServeStats", "DecodeState",
           "content_keys", "init_state", "release_slot", "splice_request"]
