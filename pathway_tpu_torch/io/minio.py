"""MinIO connector (reference ``python/pathway/io/minio``) — S3-compatible."""

from __future__ import annotations

from dataclasses import dataclass

from pathway_tpu_torch.io import s3


@dataclass
class MinIOSettings:
    endpoint: str | None = None
    bucket_name: str | None = None
    access_key: str | None = None
    secret_access_key: str | None = None
    with_path_style: bool = True

    def create_aws_settings(self):
        return s3.AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            endpoint=self.endpoint,
            with_path_style=self.with_path_style,
        )


def read(path: str, *, minio_settings: MinIOSettings | None = None, **kwargs):
    """Read from a MinIO bucket through the S3 scanner; a local path without
    settings still goes through the filesystem reader."""
    aws = minio_settings.create_aws_settings() if minio_settings else None
    return s3.read(path, aws_s3_settings=aws, **kwargs)
