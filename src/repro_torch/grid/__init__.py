"""Grid signals, reserve products, frequency synthesis and scenario
batches of the port.  Import the modules themselves (``grid.scenarios``,
``grid.frequency``, ``grid.markets``, ``grid.signals``)."""
