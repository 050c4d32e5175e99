"""Artifact sink: where delivered files go (the port's copy of
tpu_splat/pipeline/sink.py; the `aws s3 cp` replacement, main.py:1631-1840).
Local filesystem is first-class; cloud backends (GCS, S3) are pluggable URI
schemes."""

from __future__ import annotations

import os
import shutil


class ArtifactSink:
    """Copies artifacts to a destination rooted at a URI.

    file:///path or plain paths -> local copy. gs:// and s3:// raise with a clear
    message unless the respective SDK is importable (kept optional: the framework
    is cloud-agnostic and this image has no cloud SDK egress)."""

    def __init__(self, root: str):
        self.root = root

    def put(self, local_path: str, rel_key: str) -> str:
        if self.root.startswith("gs://"):
            return self._put_gcs(local_path, rel_key)
        if self.root.startswith("s3://"):
            return self._put_s3(local_path, rel_key)
        dest_root = self.root[len("file://"):] if self.root.startswith("file://") else self.root
        dest = os.path.join(dest_root, rel_key)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy2(local_path, dest)
        return dest

    def _put_gcs(self, local_path: str, rel_key: str) -> str:
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "gs:// artifact sink requires google-cloud-storage"
            ) from e
        bucket_name, _, prefix = self.root[len("gs://"):].partition("/")
        client = storage.Client()
        blob = client.bucket(bucket_name).blob(os.path.join(prefix, rel_key))
        blob.upload_from_filename(local_path)
        return f"gs://{bucket_name}/{os.path.join(prefix, rel_key)}"

    def _put_s3(self, local_path: str, rel_key: str) -> str:
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise RuntimeError("s3:// artifact sink requires boto3") from e
        bucket_name, _, prefix = self.root[len("s3://"):].partition("/")
        key = os.path.join(prefix, rel_key)
        boto3.client("s3").upload_file(local_path, bucket_name, key)
        return f"s3://{bucket_name}/{key}"
