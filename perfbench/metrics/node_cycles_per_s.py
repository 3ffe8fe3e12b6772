"""Live router node-cycles per second of the flit model: live nodes x
cycles of every `noc_run` call completed in the window, over the window's
length (host clock)."""


def read(ctx):
    work = ctx.work("node_cycles")
    return None if work is None else work / ctx.window_s
