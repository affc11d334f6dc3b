"""Message queue: partitioned pub/sub broker (reference: weed/mq/ broker +
topic packages).

Counterpart of `seaweedfs_tpu/mq/`.  No module here has a device or loads
torch: a broker that is given a filer keeps its partition logs there, as
segment files whose chunks live on the volume servers, and a read of a
chunk on a lost shard reaches the card through the volume server's
degraded read.
"""
