"""Sharding rules (:mod:`.sharding`): parameter and cache specs, and
lane sharding of a fleet across devices."""
