"""What several readers share: the window's per-request samples."""
from __future__ import annotations


def ttfts(run) -> list:
    """Seconds from each window request's due time (open loop) or send
    time (closed loop) until the host held its first token; closed loops
    keep the requests sent inside the window whose first token came
    inside it."""
    out = []
    for r in run.recs:
        if r.first is None or r.sent < run.t0:
            continue
        if run.loop == "closed" and r.first > run.t1:
            continue
        out.append(r.first - r.due)
    return out


def tpots(run) -> list:
    """Per request with two tokens or more: (last - first) / (tokens - 1);
    an open loop's requests run to their end, a closed loop's count the
    tokens that fell inside the window."""
    out = []
    for r in run.recs:
        if r.sent < run.t0:
            continue
        n, last = ((r.n_out, r.last) if run.loop == "open"
                   else (r.n_win, r.last_win))
        if n >= 2 and r.first is not None and last is not None:
            out.append((last - r.first) / (n - 1))
    return out


def tokens_in_window(run) -> int:
    return sum(r.n_win - r.n_open for r in run.recs)


def window_flops(run) -> float:
    """The model operations of the window's work: the prompt tokens
    prefilled for requests whose first token came inside the window
    (less those served from the prefix cache), and every token decoded
    inside the window (the first token of each request comes from its
    prefill), each at its real context."""
    fam, c = run.family, run.arch
    total = 0.0
    for r in run.recs:
        p = r.prompt_len
        if r.first is not None and run.t0 <= r.first <= run.t1:
            total += fam.token_flops(c, r.hit, p)
        # output j >= 1 is decoded at position p + j - 1; the window
        # decoded outputs max(n_open, 1) .. n_win - 1
        lo = max(r.n_open, 1)
        if r.n_win > lo:
            total += fam.token_flops(c, p + lo - 1, p + r.n_win - 1)
    return total
