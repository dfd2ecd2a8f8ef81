"""Traffic drivers: each module serves one kind of traffic mix, read from a
hrbench/traffic/<mix>.json file whose "driver" key names it."""
