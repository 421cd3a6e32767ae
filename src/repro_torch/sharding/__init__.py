"""The fleet mesh's row partition (``rules.FleetSharding``)."""
