"""Host time inside the program's ``ingest.*`` spans (the images turned
gray, letterboxed, stacked and copied to the device), per image encoded."""
from benchmark.program import program
from benchmark.readers import Context


def read(ctx: Context):
    if ctx.kind != "closed" or ctx.items == 0:
        return None
    upload = program(ctx, "ingest.upload")
    if upload is None:
        return None
    host = sum(row["host_s"] for name, row in ctx.trace["program"].items()
               if name.startswith("ingest."))
    return 1e3 * host / ctx.items
