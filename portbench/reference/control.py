"""The control of ``correct``: the reference's ingest put in the program's
place, with its counters held in float16, the 16-bit step below the int32
counters the configurations state.

Half precision holds every integer only up to 2,048; above that an added 1
rounds away, so a cell that one pass (or one delta between publishes) hits
more often than that reads low.  One pass of the cit-HepPh stream puts
about 14,000-17,000 edges into its hottest counter, so the control must
come out not correct; the benchmark's own runs never run it.

``ControlModule`` stands in for the program's sketch module inside the
harness: ``empty_like`` and ``merge`` are the program's, ``ingest`` works
out each edge's cells with the reference (``counters.batch_counters``'s
addressing) and adds its weight into a float16 copy of the sketch's
counters with an accumulating ``index_put_``, then stores the result back
as int32.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.counters import Layout
from portbench.reference.plan import fastrange, mix


def batch_cells(layout: Layout, src, dst, weight):
    """(flat index, weight) of every counter update one batch makes, in
    the reference's flat layout (int64 arrays)."""
    plan = layout.plan
    d = plan.depth
    rows = np.arange(d, dtype=np.int64)[:, None]
    weight = np.asarray(weight, np.int64)
    hs, ht = mix(plan.a, plan.b, src), mix(plan.a, plan.b, dst)
    nz = weight != 0
    if plan.kind == "gmatrix":
        w = plan.w
        idx = rows * w * w + fastrange(hs, w) * w + fastrange(ht, w)
        return (idx[:, nz].ravel(),
                np.broadcast_to(weight[nz], idx[:, nz].shape).ravel())
    live = weight > 0
    p = plan.route(src)
    wp = plan.widths[p]
    idx = (layout.part_off[p] + rows * wp * wp + fastrange(hs, wp) * wp
           + fastrange(ht, wp))
    cw = plan.conn_w
    cidx = (layout.conn_off + rows * cw * cw + fastrange(hs, cw) * cw
            + fastrange(ht, cw))
    return (np.concatenate([idx[:, live].ravel(), cidx[:, nz].ravel()]),
            np.concatenate([
                np.broadcast_to(weight[live], idx[:, live].shape).ravel(),
                np.broadcast_to(weight[nz], cidx[:, nz].shape).ravel()]))


class ControlModule:
    """The program's sketch module with ``ingest`` replaced by the
    reference's, accumulating in float16."""

    def __init__(self, program_mod, layout: Layout):
        self._mod = program_mod
        self.layout = layout

    def empty_like(self, sk):
        return self._mod.empty_like(sk)

    def merge(self, a, b):
        return self._mod.merge(a, b)

    def _views(self, sk):
        """(flat offset, int32 view) of each reference block in ``sk``."""
        plan, lay = self.layout.plan, self.layout
        if plan.kind == "gmatrix":
            return [(0, sk.table)]
        views = [(int(lay.part_off[p]),
                  sk.pools[int(plan.part_class[p])][:, int(plan.part_index[p])])
                 for p in range(len(plan.widths))]
        return views + [(lay.conn_off, sk.conn)]

    def ingest(self, sk, batch):
        views = self._views(sk)
        dev = views[0][1].device
        flat = torch.zeros(self.layout.size, dtype=torch.float16, device=dev)
        for off, view in views:
            flat[off:off + view.numel()] = view.reshape(-1).to(torch.float16)
        idx, w = batch_cells(self.layout, batch.src.cpu().numpy(),
                             batch.dst.cpu().numpy(),
                             batch.weight.cpu().numpy())
        flat.index_put_((torch.as_tensor(idx, device=dev),),
                        torch.as_tensor(w, device=dev).to(torch.float16),
                        accumulate=True)
        for off, view in views:
            view.copy_(flat[off:off + view.numel()].view(view.shape)
                       .to(torch.int32))
        return sk
