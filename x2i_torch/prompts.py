"""Demo prompt banks, the port's own copy of ``x2i_tpu/prompts.py``: the
reference's per-task multilingual sampling protocol (one long scene
description per language, EN/ZH/DE/FR/JA/VI, for text2image, and
instruction-editing, expression and OCR-style prompts for
imagetext2image), iterated as bank x seeds.
"""

TEXT2IMAGE_MULTILINGUAL = {
    "EN": ("A weathered lighthouse stands on a rocky headland at dusk, its "
           "beam sweeping across rolling fog banks while fishing boats "
           "with lanterns return to a small harbor below; painted in warm "
           "oil tones with thick impasto strokes, low camera angle, gulls "
           "circling a violet-and-amber sky."),
    "ZH": ("黄昏时分，一座饱经风霜的灯塔矗立在嶙峋的海岬上，"
           "光束扫过翻滚的雾气，挂着灯笼的渔船正驶回山脚下的小港口；"
           "画面以温暖的油画色调和厚重的笔触呈现，低机位视角，"
           "海鸥盘旋在紫色与琥珀色交织的天空中。"),
    "DE": ("Ein verwitterter Leuchtturm steht in der Abenddämmerung auf "
           "einer felsigen Landzunge, sein Lichtstrahl streicht über "
           "wogende Nebelbänke, während Fischerboote mit Laternen in den "
           "kleinen Hafen darunter zurückkehren; gemalt in warmen Öltönen "
           "mit pastosem Strich, niedriger Kamerawinkel, Möwen kreisen am "
           "violett-bernsteinfarbenen Himmel."),
    "FR": ("Un phare patiné se dresse sur un promontoire rocheux au "
           "crépuscule, son faisceau balayant des bancs de brume tandis "
           "que des bateaux de pêche aux lanternes regagnent le petit "
           "port en contrebas ; peint dans des tons chauds à l'huile avec "
           "des touches épaisses, angle de caméra bas, des mouettes "
           "tournoient dans un ciel violet et ambré."),
    "JA": ("夕暮れ時、風化した灯台が岩だらけの岬に立ち、"
           "その光がうねる霧の帯を掃き、提灯を灯した漁船が"
           "眼下の小さな港へ戻っていく。温かな油彩の色調と"
           "厚塗りの筆致で描かれ、低いカメラアングル、"
           "紫と琥珀色の空にカモメが旋回している。"),
    "VI": ("Một ngọn hải đăng phong sương đứng trên mũi đá lúc hoàng hôn, "
           "luồng sáng quét qua những dải sương mù cuồn cuộn trong khi "
           "những chiếc thuyền đánh cá treo đèn lồng trở về bến cảng nhỏ "
           "phía dưới; vẽ bằng tông màu sơn dầu ấm với nét cọ dày, góc "
           "máy thấp, đàn mòng biển lượn trên bầu trời tím pha hổ phách."),
}

IMAGETEXT2IMAGE_INSTRUCTIONS = [
    "Refer to the image style and generate a sleeping red fox",
    "Make the person in the picture laugh out loud",
    "Make the person in the picture sad",
    "Make the person in the picture smile",
    "Add a bicycle in the picture",
    "With snow-capped mountains in the background.",
    "OCR text recognition.",
]


def text2image_bank():
    """[(language, prompt), ...] in the reference's language order."""
    return list(TEXT2IMAGE_MULTILINGUAL.items())
