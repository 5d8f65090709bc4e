"""The rows of a data-parallel step, and where they meet.

A data-parallel step (`parallel/spmd.py`) runs the forward once per data
row of the mesh, each row on its own slice of the batch, one host
thread per row. Where the one-device math couples the batch, the rows
meet: every row hands in a value, one of them combines all the values
once, and each row takes its share of the result. The meetings of a
step are numbered in program order, so the k-th meeting combines the
k-th value of every row, and the combines run in that order.

The model calls the helpers below at its coupling points. Outside a
data-parallel row (one device, or the whole batch on one row) each is
the plain one-device expression, so the one-device path does not change:

  * `batch_draw` — a draw with a batch axis (dropout, ST_WA's data
    latent) is made once for the global shape on the one generator and
    sliced: the numbers of the one-device draw, in its order;
  * `shared_draw` — a draw with no batch axis (CCRNN's teacher-forcing
    coin, ST_WA's layer latents, ST_WA's fallback generator) is made
    once and every row reads it;
  * `batch_sum` — a differentiable sum over rows (`BatchStatsNorm`'s
    statistics);
  * `on_global_batch` — a function of the whole batch, computed once
    on the concatenated rows and sliced back (GPT-ST's mask).

Where the mesh's 'data' axis spans processes (`core/distributed.py`),
each meeting is also a meeting of the processes, in the same program
order: the rows of this process combine first, then the processes
(`parallel/collectives.py`). `batch_sum` is an all-reduce whose
backward sums the gradients over processes too; `batch_count` the
rows' sum times the processes, with no collective (the data axis
splits over processes only a batch it divides, so every process's rows
hold as many entries); `batch_draw` draws the global shape from every
process's generator (seeded alike, on the same device type) and takes
this process's slice, and `shared_draw` needs no communication at all;
`on_global_batch` all-gathers the rows' inputs.

`current_row()` tells a sharded graph support which of this process's
rows' ranks to run on. `ROW_LAUNCHES` tallies the kernel launches of
each row's forward.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import torch

from gptst_tpu_torch.kernels.spmm import tally_launches
from gptst_tpu_torch.parallel import collectives

_LOCAL = threading.local()
# the kernel launches made in data row r's forwards, {r: {kernel: n}},
# since the last `ROW_LAUNCHES.clear()`; the backward runs outside the
# rows and adds to `kernels/spmm.LAUNCHES` alone
ROW_LAUNCHES: dict[int, dict[str, int]] = {}


class RowReleased(RuntimeError):
    """Raised in a row waiting at a meeting when another row failed."""


class RowGroup:
    """The `n` rows of one data-parallel forward in this process, and
    with `processes` above 1 the same rows of every other process (this
    one's index `process`)."""

    def __init__(self, n: int, processes: int = 1, process: int = 0):
        self.n = n
        self.processes, self.process = processes, process
        self._cond = threading.Condition()
        self._meetings: dict[int, dict] = {}
        self._failed = False
        self._token = None        # orders the backward's all-reduces

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The differentiable SUM of t over processes (one call per
        meeting, in program order)."""
        out, self._token = collectives.all_reduce_sum(t, self._token)
        return out

    def fail(self) -> None:
        """Release every row waiting at a meeting: a row raised."""
        with self._cond:
            self._failed = True
            self._cond.notify_all()

    def meet(self, row: int, k: int, value: Any,
             combine: Callable[[list, "RowGroup"], list]) -> Any:
        """Meeting k: hand in `value`; once every row has, `combine`
        runs once on the values in row order (and the group) and
        returns one result per row. Returns this row's."""
        n = self.n
        with self._cond:
            m = self._meetings.setdefault(
                k, {"values": [None] * n, "left": n, "out": None,
                    "error": None})
            m["values"][row] = value
            m["left"] -= 1
            if m["left"] == 0:
                try:
                    m["out"] = combine(m["values"], self)
                except BaseException as e:   # every row raises it
                    m["error"] = e
                m["values"] = None
                self._cond.notify_all()
            else:
                while (m["out"] is None and m["error"] is None
                       and not self._failed):
                    self._cond.wait()
            if m["error"] is not None:
                raise m["error"]
            if m["out"] is None:
                raise RowReleased("another data row failed")
            return m["out"][row]


class row_scope:
    """Within the block the calling thread is row `row` of `group`."""

    def __init__(self, group: RowGroup, row: int):
        self.group, self.row = group, row

    def __enter__(self):
        self._saved = getattr(_LOCAL, "state", None)
        _LOCAL.state = [self.group, self.row, 0]
        self._tally = tally_launches(ROW_LAUNCHES.setdefault(self.row, {}))
        self._tally.__enter__()
        return self

    def __exit__(self, *exc):
        self._tally.__exit__(*exc)
        _LOCAL.state = self._saved


def current_row() -> int | None:
    """The data row the calling thread runs, or None outside a
    data-parallel forward."""
    st = getattr(_LOCAL, "state", None)
    return None if st is None else st[1]


def _meet(value, combine):
    st = _LOCAL.state
    group, row, k = st
    st[2] = k + 1
    return group.meet(row, k, value, combine)


def _in_rows() -> bool:
    return getattr(_LOCAL, "state", None) is not None


def batch_draw(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
               device: torch.device, dim: int = 0) -> torch.Tensor:
    """`draw(shape)`; in a data row, `draw` of the global shape (the
    rows' sizes summed on axis `dim`, over every process), made once,
    and this row's slice on `device`."""
    if not _in_rows():
        return draw(tuple(shape))

    def combine(shapes, group):
        sizes = [s[dim] for s in shapes]
        full = list(shapes[0])
        full[dim] = sum(sizes) * group.processes
        mine = draw(tuple(full)).narrow(dim, sum(sizes) * group.process,
                                        sum(sizes))
        return list(mine.split(sizes, dim))

    return _meet(tuple(shape), combine).to(device)


def shared_draw(draw: Callable[[], Any],
                device: torch.device | None = None) -> Any:
    """`draw()`; in a data row, made once and read by every row (a
    tensor moved to `device` when one is given)."""
    if not _in_rows():
        return draw()
    t = _meet(None, lambda values, _: [draw()] * len(values))
    return t if device is None else t.to(device)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """`t`; in a data row, the sum of every row's `t` (the same shape)
    over every process, on this row's device. Differentiable."""
    if not _in_rows():
        return t

    def combine(values, group):
        root = values[0].device
        total = values[0]
        for v in values[1:]:
            total = total + v.to(root)
        if group.processes > 1:
            total = group.all_reduce_sum(total)
        return [total] * len(values)

    return _meet(t, combine).to(t.device)


def batch_count(n: int) -> int:
    """`n`; in a data row, the sum of every row's `n` over every
    process: this process's rows' sum times the processes, as
    `batch_draw`'s global shape is. A data axis splits over processes
    only a batch it divides (`parallel/spmd.DataParallel`), so every
    process's rows count alike, and nothing is read from the device."""
    if not _in_rows():
        return n

    def combine(values, group):
        return [sum(values) * group.processes] * len(values)

    return _meet(n, combine)


def on_global_batch(fn: Callable[[torch.Tensor], torch.Tensor],
                    t: torch.Tensor) -> torch.Tensor:
    """`fn(t)`, `t` batch-first; in a data row, `fn` of the rows' `t`
    concatenated in row order (and process order), computed once in
    each process, and this row's batch slice of the result on `t`'s
    device. `fn` must map the batch axis to the batch axis. Across
    processes `t` takes no gradient (GPT-ST passes its guide
    detached)."""
    if not _in_rows():
        return fn(t)

    def combine(values, group):
        root = values[0].device
        sizes = [v.shape[0] for v in values]
        local = torch.cat([v.to(root) for v in values])
        if group.processes == 1:
            return list(fn(local).split(sizes))
        if local.requires_grad:
            raise ValueError("on_global_batch across processes takes "
                             "no gradient: detach its input")
        out = fn(collectives.all_gather_cat(local))
        return list(out.narrow(0, sum(sizes) * group.process,
                               sum(sizes)).split(sizes))

    return _meet(t, combine).to(t.device)
