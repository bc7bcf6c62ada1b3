"""The benchmark's own library: finding cells, configurations, traffic mixes
and metrics by name, the import guard, the roofline yardstick, the device
trace's reduction and the host-clock statistics.

Nothing here imports the program under test (`repro_torch`); the program is
reached only through `bench/systems/`.
"""
