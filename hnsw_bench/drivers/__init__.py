"""One module per kind of traffic, named by a traffic mix's `driver`.

A driver has `setup(run) -> state` (builds what the traffic needs and runs
every shape once), `step(state, run) -> int` (one unit of the closed loop,
returning the queries or rows it served), `window_metrics(state, run,
seconds) -> dict` (the end-to-end readings of the window),
`products(state, run) -> dict` (what the window produced, for the check:
`answers` = (query ids, labels, distances), and `adj0` for a graph).
"""
