"""The plain twin of K3/K9's new-token draw, for the CPU tests.

The fused decoder-layer kernels read the new token's score draw ``rs[b, t,
h, pos[b]]`` themselves and force it unbeatable (``2**30``) where the write
does not land.  These functions state that rule in torch, so that the tests
can hold it against the JAX package's ``_rs_at_pos``; the port's CPU path
does not need them (it scatters, then attends).
"""

from typing import Optional

import torch

INVALID_RS = 2 ** 30  # a comparator draw no AND-count can beat


def rs_at_pos(rs4: torch.Tensor, pos: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """``rs[b, :, :, pos[b]]`` ``[B, T, H]``, forced to :data:`INVALID_RS`
    where ``valid`` is false."""
    l = rs4.shape[-1]
    idx = pos.clamp(0, l - 1).to(torch.int64)
    rsp = torch.take_along_dim(rs4, idx[:, None, None, None], dim=3)[..., 0]
    return torch.where(valid[:, None, None], rsp,
                       torch.full_like(rsp, INVALID_RS))


def new_token_draw(rs4: torch.Tensor, pos: torch.Tensor,
                   page_table: Optional[torch.Tensor] = None,
                   write_pids: Optional[torch.Tensor] = None,
                   page_len: int = 0) -> torch.Tensor:
    """The draw where the write lands -- dense: ``pos < L``; paged: also
    ``page_table[b, pos // page_len] == write_pids[b]`` (the column clamped
    into the table) -- else :data:`INVALID_RS`."""
    l = rs4.shape[-1]
    valid = pos < l
    if page_table is not None:
        col = (pos // page_len).clamp(0, page_table.shape[1] - 1)
        reach = torch.take_along_dim(page_table, col[:, None].to(torch.int64),
                                     dim=1)[:, 0]
        valid = valid & (reach.to(torch.int64) == write_pids.to(torch.int64))
    return rs_at_pos(rs4, pos, valid)
