"""Distributed layer of the port: the mp=1 fleet layers the Llama model
is built from, the fault registry (``fault.py``) and the degraded-path
report (``watchdog.report_degraded``)."""
