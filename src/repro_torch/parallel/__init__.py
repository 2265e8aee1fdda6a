"""Lane sharding of a fleet across devices (:mod:`.sharding`)."""
