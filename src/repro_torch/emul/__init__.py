"""Guest-kernel emulation carry (layout only; the service is not ported yet)."""
