"""flash_attn_device_share.generate (%): the port's flash kernels' device
time over all device time in the traced pass, read as
`flash_attn_device_share.train` reads a traced epoch."""

from perfbench import spec

read = spec.metric_reader("flash_attn_device_share.train").read
