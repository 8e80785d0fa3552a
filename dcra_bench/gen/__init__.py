"""Input generators: everything a cell feeds the port is made here from
``--seed``, on the run's device, in a few large calls."""
