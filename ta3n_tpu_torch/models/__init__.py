from ta3n_tpu_torch.models.video_model import StreamOutput, VideoModel

__all__ = ["VideoModel", "StreamOutput"]
