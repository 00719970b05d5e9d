"""Row sharding of the struct-of-arrays over devices and processes."""
