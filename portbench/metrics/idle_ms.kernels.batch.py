"""Milliseconds a traced call in which the card ran nothing while the host was
inside ``fpv.kernel.*``: the host side of the hand-written kernels'
wrappers (checks, operand copies, the launch), in the batched cells
(``portbench.spans``)."""

from portbench.spans import reader

read = reader("kernel")
