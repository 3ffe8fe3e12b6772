"""Set-up time: from the process's start to the window's (imports, card
start-up, kernel builds or library loads, inputs drawn from the seed, one
warm call per shape)."""


def read(ctx):
    return ctx.setup_s
