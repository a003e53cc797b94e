"""Device stages of the decode slice."""
