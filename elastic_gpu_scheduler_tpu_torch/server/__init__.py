"""HTTP front end of the port's serving engine."""
