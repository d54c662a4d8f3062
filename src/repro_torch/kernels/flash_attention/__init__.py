"""Flash attention: ``ops.flash_attention`` (kernel or plain version by device)."""
