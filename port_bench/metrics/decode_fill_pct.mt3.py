"""decode_fill_pct.mt3: the tokens the segments emitted over the rows the
decode steps computed (`mt3.tokens_emitted` / `mt3.token_rows_run`, the
transcriber's counters in the traced span), in percent: below 100, steps
ran rows that had finished."""

from pb import spans


def read(run):
    got = spans.summary(run, "mt3")
    if got is None or not got["counters"].get("mt3.token_rows_run"):
        return None
    return 100.0 * got["counters"]["mt3.tokens_emitted"] / got["counters"]["mt3.token_rows_run"]
