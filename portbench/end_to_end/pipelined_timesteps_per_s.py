"""The pipelined trainer's timesteps/s: ``timesteps_per_s``'s reader, apart
so that its spread sets only its own bound."""
from portbench import spec

read = spec.reader("timesteps_per_s", "end_to_end")
