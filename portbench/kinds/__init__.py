"""One module per kind of traffic (`traffic/<mix>.json`'s "kind"): its
`run(...)` sets up and drives the program for one cell and returns what
`run.py` reports."""
