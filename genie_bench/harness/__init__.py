"""The general parts of the benchmark: loading a cell, the traffic loop,
the trace reduction, the peaks and the checks of every answer."""
