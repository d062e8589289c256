"""Lane engines: the rounds of each traced frame as the program counts them
(``Renderer.rounds``; on a mesh of cards the shards' rounds summed), their
mean."""

UNIT = "rounds"
LAYER = "Lane engines (integrator/wavefront.py)"


def _total(r):
    return sum(_total(x) for x in r) if isinstance(r, (list, tuple)) else r


def read(ctx):
    if not ctx.rounds:
        return None
    return sum(_total(r) for r in ctx.rounds) / len(ctx.rounds)
