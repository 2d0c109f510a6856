"""The benchmark's yardstick: discovery of cells, configurations, drivers and
metric readers by name, the weights and traffic made from ``--seed``, the
device trace and the result line.  Imports nothing of the program at import
time; the drivers import ``repro_torch`` inside their functions."""
