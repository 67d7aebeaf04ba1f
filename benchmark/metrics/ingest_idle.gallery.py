"""The share of the traced window in which the card was idle while the
host was inside one of the program's ``ingest.*`` spans: the card waiting
on the host's work on the images."""
from benchmark.program import program
from benchmark.readers import Context


def read(ctx: Context):
    if ctx.kind != "closed" or program(ctx, "ingest.upload") is None:
        return None
    idle = sum(row["idle_s"] for name, row in ctx.trace["program"].items()
               if name.startswith("ingest."))
    return 100.0 * idle / ctx.trace["window_s"]
