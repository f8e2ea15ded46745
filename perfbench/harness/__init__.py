"""The harness: cells found by name (``core``), the runners of the traffic
kinds (``submit``), seeded weights (``params``), the traced run's
instruments (``trace``) and the yardstick's bounds (``bounds``)."""
