"""request_p95_ms: the 95th percentile of the latencies of all requests
completed in the window, each from its submission to its completion on the
scheduler's clock (host). A request that failed counts as waiting the whole
window."""
import numpy as np


def read(ctx):
    lat = [d.t_finish - d.t_submit if d.ok else ctx.loop.window_s for d in ctx.loop.done]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
