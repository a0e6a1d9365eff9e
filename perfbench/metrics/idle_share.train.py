"""% of the traced sub-window in which no operation ran on the card."""
from perfbench.readers import idle_share


def read(r):
    return idle_share(r)
