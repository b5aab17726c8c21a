"""The systems under test, one module per kind of configuration.

A configuration file's ``"system"`` names the module. Each module's
``Cell(config, traffic, seed, device)`` makes the inputs from the seed and
sets the program up (``setup``), drives it for a window (``window``),
drops the program's state (``release``) and holds what the window
produced to the plain reference (``check``, which returns the compared
numbers by name and how many answers it compared).
"""
