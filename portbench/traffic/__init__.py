"""Traffic: the frozen generators (``stream.py``, ``requests.py``), each
mix's parameters (``<mix>.json``) and each kind's loop (``<kind>.py``)."""
