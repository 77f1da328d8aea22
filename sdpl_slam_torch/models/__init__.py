"""SLAM pipeline state machines: Frame, Map, Tracking, System."""
