"""Mean device idle (ms) before each traced call's first launch, the lift
tagged with the program's span fhe.limbs_to_residues, over every call
but the first (by_span.call_start_idle_ms): the harness's synchronise
and loop and the program's host path up to its first launch.  None
where no operation carries the tag."""
from bench_port.by_span import call_start_idle_ms as read  # noqa: F401
