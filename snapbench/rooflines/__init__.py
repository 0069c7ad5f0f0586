"""Bytes the work needs, and the device's peaks, for the roofline shares."""
