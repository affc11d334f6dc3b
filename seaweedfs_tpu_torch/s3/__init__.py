"""S3 gateway and IAM API over the filer.

Counterpart of `seaweedfs_tpu/s3/`.  No module here has a device or
loads torch: objects live in the filer, whose chunks live on the volume
servers, and a read of a lost shard reaches the card through the volume
server's degraded read.
"""
