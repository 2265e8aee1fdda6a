"""The card's idle share of a census (%): one less the device profile's
busy time a census over a census's wall time in the window's untraced
remainder."""
from bench.trace import idle_share


def read(ctx):
    return idle_share(ctx)
