"""The yardstick around the program: cell specs, data, the closed loop of
fits, the device trace and the work counts of the kernel ops."""
