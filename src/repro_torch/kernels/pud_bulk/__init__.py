"""PUD bulk ops: the pool block copy (RowClone) kernel + plain version."""
