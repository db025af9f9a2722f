"""Chat templates and prompt builders, the counterpart of
``x2i_tpu/models/templates.py`` (its strings character for character):
the InternVL2.5 prompt with its system message and task instruction, its
image placeholders (``<image>`` expanded to ``<img>``, one
``<IMG_CONTEXT>`` per ViT feature, ``</img>``), the Qwen2.5-VL message
list and the MiniCPM-o content."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

IMG_START, IMG_END, IMG_CONTEXT = "<img>", "</img>", "<IMG_CONTEXT>"
# what the InternVL encoder puts before the question of a request with
# images; expand_image_tokens replaces its "<image>"
IMAGE_PREFIX = "<image>\n"

INTERNVL_SYSTEM = ("你是书生·万象，英文名是InternVL，是由上海人工智能实验室、清华大学及"
                   "多家合作单位联合开发的多模态大语言模型。")


def internvl2_5_prompt(question: str,
                       history: Optional[Sequence[Tuple[str, str]]] = None,
                       system_message: str = INTERNVL_SYSTEM) -> str:
    """MPT-style internvl2_5 template (conversation.py:240-248,384-390):
    system + each message wrapped in <|im_start|>role ... <|im_end|>\\n, and
    an open assistant turn."""
    sep = "<|im_end|>\n"
    ret = f"<|im_start|>system\n{system_message}" + sep
    for old_q, old_a in history or []:
        ret += "<|im_start|>user\n" + old_q + sep
        ret += "<|im_start|>assistant\n" + old_a + sep
    ret += "<|im_start|>user\n" + question + sep
    ret += "<|im_start|>assistant\n"
    return ret


def expand_image_tokens(query: str, num_patches_list: Sequence[int],
                        tokens_per_patch: int = 256) -> str:
    """Replace each '<image>' with <img><IMG_CONTEXT>*256*patches</img>
    (inference_internvl.py:122-124)."""
    for num_patches in num_patches_list:
        image_tokens = (IMG_START
                        + IMG_CONTEXT * tokens_per_patch * num_patches
                        + IMG_END)
        query = query.replace("<image>", image_tokens, 1)
    return query


def task_instruction(task: str, prompt: Optional[str] = None,
                     num_images: int = 0, has_audio: bool = False,
                     has_video: bool = False) -> str:
    """InternVL inference instruction wrapper: the user text rides
    "Text input" and the editing slot is the constant "no"
    (inference_internvl.py:165-187). MiniCPM/Qwen inference pass the RAW
    prompt instead (minicpm_omni_content / qwen_chat_messages); the richer
    dicts appear only in the training datamodules."""
    del task, num_images, has_audio, has_video
    return str({"Text input": prompt or "",
                "Instruction editing description": "no"})


def qwen_chat_messages(task: str, prompt: Optional[str],
                       num_images: int = 0, has_video: bool = False,
                       has_audio: bool = False) -> List[Dict]:
    """Qwen2.5-VL chat message list (inference_qwenvl.py:136-180):
    content = [image/video entries..., {"type": "text", raw prompt}]."""
    del task, has_audio
    content: List[Dict] = []
    for _ in range(num_images):
        content.append({"type": "image"})
    if has_video:
        content.append({"type": "video"})
    if prompt is not None:
        content.append({"type": "text", "text": prompt})
    return [{"role": "user", "content": content}]


def minicpm_omni_content(prompt: Optional[str], num_images: int = 0,
                         num_audios: int = 0,
                         num_video_frames: int = 0) -> str:
    """MiniCPM-o message content: "(<image>./</image>)\n" per image/frame,
    "(<audio>./</audio>)\n" per audio, then the RAW prompt
    (inference_minicpm.py:137-158)."""
    content = "(<image>./</image>)\n" * (num_images + num_video_frames)
    content += "(<audio>./</audio>)\n" * num_audios
    if prompt is not None:
        content += prompt
    return content
