"""Traffic kinds: ``<kind>.py`` runs a cell whose file names that kind.

Each kind's ``run(ctx)`` makes the cell's data, builds the port's engine,
warms up, measures the window, reads the device peak, frees the port's
state and compares what the window produced with the plain reference.
"""
