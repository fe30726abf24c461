"""Traffic drivers: each plays one kind of traffic from its data file."""
