"""Storage and the device shuffle, torch port."""
