"""The plain reference of the simulator: NumPy and Python only.

It lowers a workload as the configuration files state it
(``spec.py``), draws its random numbers (``prng.py``) and request plan
(``stream.py``), runs each replica event by event (``engine.py``) and
reduces replicas to the figures' and serving aggregates
(``aggregate.py``). It imports nothing of the program under test.
"""
